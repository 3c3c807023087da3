"""Optimizers and learning-rate schedules of the port (paddle_tpu/optim
counterpart)."""

from paddle_tpu_torch.optim import lr_schedules
from paddle_tpu_torch.optim.optimizer import SGD, Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer", "SGD", "lr_schedules"]
