"""Optimizers and learning-rate schedules of the port (paddle_tpu/optim
counterpart)."""

from paddle_tpu_torch.optim import lr_schedules
from paddle_tpu_torch.optim.optimizer import (
    SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, DecayedAdagrad, Ftrl, Lamb,
    LarsMomentum, ModelAverage, Momentum, Optimizer, ProximalAdagrad,
    ProximalGD, RMSProp)

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "DecayedAdagrad", "Ftrl", "Lamb", "LarsMomentum", "ModelAverage",
           "Momentum", "Optimizer", "ProximalAdagrad", "ProximalGD",
           "RMSProp", "SGD", "lr_schedules"]
