"""Metrics of the port (paddle_tpu/metrics counterpart)."""

from paddle_tpu_torch.metrics.metrics import (
    Accuracy, Auc, ChunkEvaluator, CompositeMetric, DetectionMAP,
    EditDistance, MetricBase, Precision, PrecisionRecall, Recall, accuracy,
    auc,
)
