"""The training runtime of the port (paddle_tpu/core counterpart)."""

from paddle_tpu_torch.core.executor import Trainer, supervised_loss

__all__ = ["Trainer", "supervised_loss"]
