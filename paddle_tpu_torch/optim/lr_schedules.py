"""Learning-rate schedules (port of paddle_tpu/optim/lr_schedules.py).

Each schedule is a pure function `step -> lr`: `step` is an int or an
integer tensor, and the learning rate comes back as a float32 0-d
tensor, computed in float32 in JAX's order of operations so the two
packages agree to float32 rounding.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[object], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def constant(value: float) -> Schedule:
    return lambda step: _f32(value)


def exponential_decay(learning_rate: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False) -> Schedule:
    def sched(step):
        exp = _f32(step) / decay_steps
        if staircase:
            exp = torch.floor(exp)
        return learning_rate * torch.pow(_f32(decay_rate), exp)
    return sched


def natural_exp_decay(learning_rate: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False) -> Schedule:
    def sched(step):
        exp = _f32(step) / decay_steps
        if staircase:
            exp = torch.floor(exp)
        return learning_rate * torch.exp(-decay_rate * exp)
    return sched


def inverse_time_decay(learning_rate: float, decay_steps: int,
                       decay_rate: float, staircase: bool = False) -> Schedule:
    def sched(step):
        t = _f32(step) / decay_steps
        if staircase:
            t = torch.floor(t)
        return _f32(learning_rate) / (1.0 + decay_rate * t)
    return sched


def polynomial_decay(learning_rate: float, decay_steps: int,
                     end_learning_rate: float = 1e-4, power: float = 1.0,
                     cycle: bool = False) -> Schedule:
    def sched(step):
        s = _f32(step)
        if cycle:
            ds = decay_steps * torch.clamp(torch.ceil(s / decay_steps),
                                           min=1.0)
        else:
            ds = _f32(decay_steps)
            s = torch.minimum(s, ds)
        return ((learning_rate - end_learning_rate)
                * (1.0 - s / ds) ** power + end_learning_rate)
    return sched


def piecewise_decay(boundaries: Sequence[int],
                    values: Sequence[float]) -> Schedule:
    bs = torch.tensor(boundaries, dtype=torch.int32)
    vs = torch.tensor(values, dtype=torch.float32)

    def sched(step):
        return vs[(torch.as_tensor(step) >= bs).sum()]
    return sched


def cosine_decay(learning_rate: float, step_each_epoch: int,
                 epochs: int) -> Schedule:
    def sched(step):
        epoch = torch.floor(_f32(step) / step_each_epoch)
        frac = torch.clamp(epoch / epochs, max=1.0)
        return learning_rate * 0.5 * (torch.cos(frac * math.pi) + 1.0)
    return sched


def noam_decay(d_model: int, warmup_steps: int,
               learning_rate: float = 1.0) -> Schedule:
    """The Transformer schedule (reference noam_decay)."""
    def sched(step):
        s = torch.clamp(_f32(step), min=1.0)
        return learning_rate * d_model ** -0.5 * torch.minimum(
            s ** -0.5, s * warmup_steps ** -1.5)
    return sched


def linear_warmup(base: Schedule, warmup_steps: int,
                  start_lr: float = 0.0) -> Schedule:
    """Ramp linearly from start_lr to `base` over warmup_steps."""
    def sched(step):
        s = _f32(step)
        target = base(step)
        warm = start_lr + (target - start_lr) * torch.clamp(
            s / warmup_steps, max=1.0)
        return torch.where(s < warmup_steps, warm, target)
    return sched
