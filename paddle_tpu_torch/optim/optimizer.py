"""Optimizers (port of paddle_tpu/optim/optimizer.py: the `Optimizer`
base, `SGD`, `Adam` and `AdamW`).

They are `torch.optim.Optimizer`s that update the parameters IN PLACE
(JAX returns new parameters) and keep JAX's arithmetic, in its order:

- the gradient is pre-processed as JAX's `_preprocess` does (:100-125):
  `regularization` ("l2" | "l1", coeff) first, then `grad_clip`
  ("value" | "norm" | "global_norm", bound);
- the learning rate is a float or a schedule `step -> lr`
  (optim/lr_schedules.py), evaluated at the optimizer's step count
  before it advances, in float32;
- slots are float32 (JAX's `zeros_like` of bf16 parameters is float32
  after the first update).

As in JAX, every parameter is updated on every step: a parameter that
got no gradient is updated with a zero gradient (its Adam moments still
decay).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import torch

Schedule = Callable[[object], torch.Tensor]
LR = Union[float, Schedule]

_CLIPS = ("value", "norm", "global_norm")
_REGS = ("l2", "l1")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def lr_at(lr: LR, step: int) -> torch.Tensor:
    """The float32 learning rate at `step` (a 0-d CPU tensor, which
    combines with parameters on any device)."""
    if callable(lr):
        return _f32(lr(torch.tensor(step, dtype=torch.int32)))
    return _f32(lr)


def _clip_factor(bound: float, norm: torch.Tensor) -> torch.Tensor:
    """min(1, bound / max(norm, 1e-12)) in float32."""
    return torch.clamp(torch.full_like(norm, bound)
                       / torch.clamp(norm, min=1e-12), max=1.0)


class Optimizer(torch.optim.Optimizer):
    """Base optimizer: subclasses implement `_apply_one(p, g, lr, step,
    state)`, which writes the new value into `p` and its slots into
    `state`. `step_count` is JAX's `opt_state["step"]`."""

    def __init__(self, params, learning_rate: LR = 0.01,
                 grad_clip: Optional[Tuple[str, float]] = None,
                 regularization: Optional[Tuple[str, float]] = None):
        if grad_clip is not None and grad_clip[0] not in _CLIPS:
            raise ValueError(f"unknown grad_clip {grad_clip[0]}")
        if regularization is not None and regularization[0] not in _REGS:
            raise ValueError(f"unknown regularization {regularization[0]}")
        super().__init__(params, dict(lr=learning_rate))
        self.grad_clip = grad_clip
        self.regularization = regularization
        self.step_count = 0

    def _apply_one(self, p: torch.Tensor, g: torch.Tensor,
                   lr: torch.Tensor, step: int, state: dict) -> None:
        raise NotImplementedError

    def _preprocess(self, params: List[torch.Tensor],
                    grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.regularization is not None:
            kind, coeff = self.regularization
            if kind == "l2":
                grads = [g + coeff * p for g, p in zip(grads, params)]
            else:
                grads = [g + coeff * torch.sign(p)
                         for g, p in zip(grads, params)]
        if self.grad_clip is not None:
            kind, val = self.grad_clip
            if kind == "value":
                grads = [torch.clamp(g, -val, val) for g in grads]
            elif kind == "norm":
                grads = [g * _clip_factor(val, torch.sqrt(g.square().sum()))
                         for g in grads]
            else:
                gn = torch.sqrt(sum(g.float().square().sum() for g in grads))
                factor = _clip_factor(val, gn)
                grads = [g * factor for g in grads]
        return grads

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for group in self.param_groups for p in group["params"]]
        grads = self._preprocess(params, [
            torch.zeros_like(p) if p.grad is None else p.grad
            for p in params])
        it = iter(grads)
        for group in self.param_groups:
            lr = lr_at(group["lr"], self.step_count)
            for p in group["params"]:
                self._apply_one(p, next(it), lr, self.step_count,
                                self.state[p])
        self.step_count += 1
        return loss


class SGD(Optimizer):
    """optimizer.py:135: p - lr * g in the parameter's dtype."""

    def _apply_one(self, p, g, lr, step, state):
        p.copy_(p - lr.to(p.dtype) * g.to(p.dtype))


class Adam(Optimizer):
    """optimizer.py:235: bias-corrected Adam; `weight_decay` > 0 adds
    the decoupled (AdamW) term to the update."""

    def __init__(self, params, learning_rate: LR = 0.001,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, weight_decay: float = 0.0, **kw):
        super().__init__(params, learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay

    def _apply_one(self, p, g, lr, step, state):
        if not state:
            state["m"] = torch.zeros(p.shape, device=p.device)
            state["v"] = torch.zeros(p.shape, device=p.device)
        gf = g.float()
        t = _f32(step + 1)
        m = self.beta1 * state["m"] + (1 - self.beta1) * gf
        v = self.beta2 * state["v"] + (1 - self.beta2) * gf.square()
        mhat = m / (1 - self.beta1 ** t)
        vhat = v / (1 - self.beta2 ** t)
        upd = mhat / (torch.sqrt(vhat) + self.epsilon)
        if self.weight_decay:
            upd = upd + self.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        state["m"], state["v"] = m, v


class AdamW(Adam):
    """Adam with decoupled weight decay 0.01 by default (optimizer.py:263)."""

    def __init__(self, params, learning_rate: LR = 0.001,
                 weight_decay: float = 0.01, **kw):
        super().__init__(params, learning_rate, weight_decay=weight_decay,
                         **kw)
