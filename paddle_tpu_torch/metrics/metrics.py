"""Metrics (port of paddle_tpu/metrics/metrics.py): the in-graph
functional metrics `accuracy` and `auc` as tensor ops on the input's
device, and the host-side accumulators with the same
update / eval / reset surface.

- `accuracy` with k > 1 keeps JAX's order: an ascending stable argsort
  reversed, so ties among the top k go to the HIGHER index; with k == 1
  `argmax` takes the first maximum;
- `auc` buckets by thresholds in `jnp.linspace`'s arithmetic
  (`ops.functional._linspace`) in the probabilities' dtype, so that a
  probability on a threshold falls on the same side as in JAX.

The host-side classes are numpy, as JAX's are. A tensor argument (on
the card or not) enters them through `.detach().cpu().numpy()` where
JAX calls `np.asarray`, dtype kept: `Auc.update` multiplies float32
probabilities in float32 before it buckets them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.ops.functional import _linspace


def _np(x) -> np.ndarray:
    """np.asarray of a tensor (from any device) or an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _seq(x) -> list:
    """list(x), a tensor's elements as Python numbers."""
    return x.detach().cpu().reshape(-1).tolist() \
        if isinstance(x, torch.Tensor) else list(x)


# ------------------------------------------------------------ in-graph

def accuracy(logits_or_pred, label, k: int = 1):
    """Top-k accuracy, a float32 0-d tensor. label: [N] ints."""
    label = torch.as_tensor(label, device=logits_or_pred.device)
    label = label.reshape(label.shape[0], -1)[:, 0]
    if k == 1:
        pred = torch.argmax(logits_or_pred, dim=-1)
        return torch.mean((pred == label).to(torch.float32))
    idx = torch.argsort(logits_or_pred, dim=-1, stable=True).flip(-1)[..., :k]
    return torch.mean(torch.any(idx == label[:, None], dim=-1)
                      .to(torch.float32))


def auc(probs, label, num_thresholds: int = 200):
    """AUC of one batch by threshold bucketing (the trapezoid rule over
    the ROC points), a 0-d tensor."""
    pos_prob = probs[..., -1] if probs.ndim > 1 else probs
    label = torch.as_tensor(label, device=probs.device).reshape(-1).to(
        torch.float32)
    dt = pos_prob.dtype if pos_prob.is_floating_point() else torch.float32
    thresh = _linspace(1.0, num_thresholds, dt, probs.device)
    pred_pos = pos_prob[None, :] >= thresh[:, None]
    tp = torch.sum(pred_pos * label[None, :], dim=1)
    fp = torch.sum(pred_pos * (1 - label)[None, :], dim=1)
    tpr = tp / torch.clamp(torch.sum(label), min=1e-6)
    fpr = fp / torch.clamp(torch.sum(1 - label), min=1e-6)
    return -torch.trapezoid(tpr, fpr)


# ----------------------------------------------------------- host-side state

class MetricBase:
    """update/eval/reset accumulator surface (metrics.py:57)."""

    def __init__(self, name: Optional[str] = None):
        self._name = name or type(self).__name__

    def reset(self) -> None:
        raise NotImplementedError

    def update(self, **kwargs) -> None:
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def get_config(self) -> Dict[str, Any]:
        return {"name": self._name}


class Accuracy(MetricBase):
    """Weighted streaming accuracy (metrics.py Accuracy)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(value) * float(weight)
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy: no updates yet")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = _np(preds).round().astype(int).reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = _np(preds).round().astype(int).reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(MetricBase):
    """Streaming AUC with threshold buckets (metrics.py:459)."""

    def __init__(self, num_thresholds: int = 4095, name=None):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._neg = np.zeros(self.num_thresholds + 1, np.int64)

    def update(self, preds, labels):
        preds = _np(preds)
        pos_prob = preds[..., -1] if preds.ndim > 1 else preds
        labels = _np(labels).reshape(-1)
        idx = np.clip((pos_prob * self.num_thresholds).astype(int),
                      0, self.num_thresholds)
        for i, l in zip(idx, labels):
            if l:
                self._pos[i] += 1
            else:
                self._neg[i] += 1

    def eval(self):
        tot_pos = self._pos.sum()
        tot_neg = self._neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # integrate ROC from the highest threshold down
        tp = np.cumsum(self._pos[::-1])
        fp = np.cumsum(self._neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(np.trapezoid(tpr, fpr))


class EditDistance(MetricBase):
    """Streaming normalized Levenshtein distance (metrics.py:316,
    operators/edit_distance_op.cc capability)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0
        self.correct = 0

    @staticmethod
    def distance(a: Sequence, b: Sequence) -> int:
        m, n = len(a), len(b)
        dp = np.arange(n + 1)
        for i in range(1, m + 1):
            prev = dp[0]
            dp[0] = i
            for j in range(1, n + 1):
                cur = dp[j]
                dp[j] = min(dp[j] + 1, dp[j - 1] + 1,
                            prev + (a[i - 1] != b[j - 1]))
                prev = cur
        return int(dp[n])

    def update(self, hyps, refs):
        for h, r in zip(hyps, refs):
            d = self.distance(_seq(h), _seq(r))
            self.total += d / max(len(r), 1)
            self.count += 1
            self.correct += (d == 0)

    def eval(self):
        if not self.count:
            return 0.0, 0.0
        return self.total / self.count, self.correct / self.count


class ChunkEvaluator(MetricBase):
    """F1 over extracted chunks (metrics.py:219, chunk_eval_op capability).
    update() takes counts; chunk extraction lives with the tagging model."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer = 0
        self.num_label = 0
        self.num_correct = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer += int(num_infer_chunks)
        self.num_label += int(num_label_chunks)
        self.num_correct += int(num_correct_chunks)

    def eval(self):
        precision = (self.num_correct / self.num_infer
                     if self.num_infer else 0.0)
        recall = (self.num_correct / self.num_label
                  if self.num_label else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return precision, recall, f1


class CompositeMetric(MetricBase):
    """Bundle of metrics updated together (metrics.py:142)."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics: List[MetricBase] = []

    def add_metric(self, metric: MetricBase):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class PrecisionRecall(MetricBase):
    """Multiclass streaming precision/recall/F1 (reference
    operators/metrics/precision_recall_op.cc: accumulates per-class
    TP/FP/FN and reports macro + micro averages)."""

    def __init__(self, num_classes: int, name=None):
        super().__init__(name)
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.tp = np.zeros(self.num_classes, np.int64)
        self.fp = np.zeros(self.num_classes, np.int64)
        self.fn = np.zeros(self.num_classes, np.int64)

    def update(self, preds, labels):
        """preds: [N] predicted class ids (or [N, C] scores); labels [N]."""
        preds = _np(preds)
        if preds.ndim == 2:
            preds = preds.argmax(-1)
        preds = preds.astype(int).reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        for c in range(self.num_classes):
            self.tp[c] += int(np.sum((preds == c) & (labels == c)))
            self.fp[c] += int(np.sum((preds == c) & (labels != c)))
            self.fn[c] += int(np.sum((preds != c) & (labels == c)))

    def eval(self):
        """Returns dict with macro/micro precision, recall, f1."""
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = np.where(self.tp + self.fp > 0,
                            self.tp / np.maximum(self.tp + self.fp, 1), 0.0)
            rec = np.where(self.tp + self.fn > 0,
                           self.tp / np.maximum(self.tp + self.fn, 1), 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec
                      / np.maximum(prec + rec, 1e-12), 0.0)
        tp, fp, fn = self.tp.sum(), self.fp.sum(), self.fn.sum()
        micro_p = tp / max(tp + fp, 1)
        micro_r = tp / max(tp + fn, 1)
        micro_f = (2 * micro_p * micro_r / max(micro_p + micro_r, 1e-12)
                   if micro_p + micro_r else 0.0)
        return {"macro_precision": float(prec.mean()),
                "macro_recall": float(rec.mean()),
                "macro_f1": float(f1.mean()),
                "micro_precision": float(micro_p),
                "micro_recall": float(micro_r),
                "micro_f1": float(micro_f)}


class DetectionMAP(MetricBase):
    """Mean average precision for detection (reference metrics.py:566
    DetectionMAP + operators/detection_map_op.cc).

    update() takes per-image detections [[label, score, x1, y1, x2, y2],
    ...] and ground truth [[label, x1, y1, x2, y2], ...]; eval() returns
    mAP over classes using 11-point or integral interpolation.
    """

    def __init__(self, overlap_threshold: float = 0.5,
                 ap_version: str = "integral",
                 evaluate_difficult: bool = False, name=None):
        super().__init__(name)
        if ap_version not in ("integral", "11point"):
            raise ValueError(f"unknown ap_version: {ap_version!r}")
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.evaluate_difficult = evaluate_difficult
        self.reset()

    def reset(self):
        # per class: list of (score, is_tp); and gt count
        self._scored: Dict[int, list] = {}
        self._npos: Dict[int, int] = {}

    @staticmethod
    def _iou(a, b):
        ax1, ay1, ax2, ay2 = a
        bx1, by1, bx2, by2 = b
        iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
        ih = max(0.0, min(ay2, by2) - max(ay1, by1))
        inter = iw * ih
        ua = max((ax2 - ax1) * (ay2 - ay1), 0) + \
            max((bx2 - bx1) * (by2 - by1), 0) - inter
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, gts, difficult=None):
        detections = [list(map(float, d)) for d in _np(detections)
                      .reshape(-1, 6)] if len(detections) else []
        gts = [list(map(float, g)) for g in _np(gts).reshape(-1, 5)] \
            if len(gts) else []
        difficult = ([bool(d) for d in difficult] if difficult is not None
                     else [False] * len(gts))
        for (glabel, *_), diff in zip(gts, difficult):
            if self.evaluate_difficult or not diff:
                self._npos[int(glabel)] = self._npos.get(int(glabel), 0) + 1
        used = [False] * len(gts)
        for label, score, x1, y1, x2, y2 in sorted(
                detections, key=lambda d: -d[1]):
            label = int(label)
            if label < 0:
                continue
            best, best_j = 0.0, -1
            for j, (glabel, gx1, gy1, gx2, gy2) in enumerate(gts):
                if int(glabel) != label or used[j]:
                    continue
                ov = self._iou((x1, y1, x2, y2), (gx1, gy1, gx2, gy2))
                if ov > best:
                    best, best_j = ov, j
            tp = best >= self.overlap_threshold and best_j >= 0
            if tp and not (difficult[best_j] and not self.evaluate_difficult):
                used[best_j] = True
                self._scored.setdefault(label, []).append((score, 1))
            elif tp:
                pass  # difficult match: neither tp nor fp
            else:
                self._scored.setdefault(label, []).append((score, 0))

    def eval(self):
        aps = []
        for label, npos in self._npos.items():
            scored = sorted(self._scored.get(label, []), key=lambda s: -s[0])
            if not scored or npos == 0:
                aps.append(0.0)
                continue
            tps = np.cumsum([t for _, t in scored])
            fps = np.cumsum([1 - t for _, t in scored])
            rec = tps / npos
            prec = tps / np.maximum(tps + fps, 1)
            if self.ap_version == "11point":
                ap = 0.0
                for t in np.linspace(0, 1, 11):
                    p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
                    ap += p / 11
            else:
                # integral: sum precision deltas at each recall step
                mrec = np.concatenate([[0.0], rec])
                ap = float(np.sum((mrec[1:] - mrec[:-1]) * prec))
            aps.append(float(ap))
        return float(np.mean(aps)) if aps else 0.0
