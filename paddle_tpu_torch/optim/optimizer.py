"""Optimizers (port of paddle_tpu/optim/optimizer.py: the `Optimizer`
base, its fourteen optimizers and `ModelAverage`).

They are `torch.optim.Optimizer`s that update the parameters IN PLACE
(JAX returns new parameters) and keep JAX's arithmetic, in its order:

- the gradient is pre-processed as JAX's `_preprocess` does (:100-125):
  `regularization` ("l2" | "l1", coeff) first, then `grad_clip`
  ("value" | "norm" | "global_norm", bound);
- the learning rate is a float or a schedule `step -> lr`
  (optim/lr_schedules.py), evaluated at the optimizer's step count
  before it advances, in float32;
- slots are float32 (JAX's `zeros_like` of bf16 parameters is float32
  after the first update), under JAX's slot names (`SLOTS`, made by
  `init_slots` at a parameter's first update), and are updated in place,
  as the parameters are: a `TrainState` view (core/executor.py) stays
  live across steps.

As in JAX, every parameter is updated on every step: a parameter that
got no gradient is updated with a zero gradient (its Adam moments still
decay).
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterable, List, Optional, Tuple,
                    Union)

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
    """Base optimizer: subclasses name their slots in `SLOTS` and
    implement `_apply_one(p, g, lr, step, slots)`, which writes the new
    value into `p` and its slots into `slots`, in place. `step_count` is
    JAX's `opt_state["step"]`."""

    SLOTS: Tuple[str, ...] = ()

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
        # norm clipping's hook: (params, squared sums of their gradients)
        # -> the squared sums of the whole gradients. None on one device;
        # MeshTrainer sums a shard's over the ranks holding its leaf
        self.sum_sq: Optional[Callable[
            [List[torch.Tensor], List[torch.Tensor]],
            List[torch.Tensor]]] = None

    def init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """JAX's `init_slots` for one parameter: float32 zeros under each
        slot name."""
        return {name: torch.zeros(p.shape, device=p.device)
                for name in self.SLOTS}

    def slots_of(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """`p`'s slots, made by `init_slots` at first use."""
        state = self.state[p]
        if not state:
            state.update(self.init_slots(p))
        return state

    def _apply_one(self, p: torch.Tensor, g: torch.Tensor,
                   lr: torch.Tensor, step: int,
                   slots: Dict[str, torch.Tensor]) -> None:
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
                sq = self._sum_sq(params, [g.square().sum() for g in grads])
                grads = [g * _clip_factor(val, torch.sqrt(s))
                         for g, s in zip(grads, sq)]
            else:
                gn = torch.sqrt(sum(self._sum_sq(
                    params, [g.float().square().sum() for g in grads])))
                factor = _clip_factor(val, gn)
                grads = [g * factor for g in grads]
        return grads

    def _sum_sq(self, params: List[torch.Tensor],
                sq: List[torch.Tensor]) -> List[torch.Tensor]:
        return sq if self.sum_sq is None else self.sum_sq(params, sq)

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
                                self.slots_of(p))
        self.step_count += 1
        return loss


class SGD(Optimizer):
    """optimizer.py:135: p - lr * g in the parameter's dtype."""

    def _apply_one(self, p, g, lr, step, slots):
        p.copy_(p - lr.to(p.dtype) * g.to(p.dtype))


class Momentum(Optimizer):
    """optimizer.py:142: heavy-ball momentum (+ use_nesterov)."""

    SLOTS = ("velocity",)

    def __init__(self, params, learning_rate: LR = 0.01,
                 momentum: float = 0.9, use_nesterov: bool = False, **kw):
        super().__init__(params, learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _apply_one(self, p, g, lr, step, slots):
        g = g.to(p.dtype)
        lr = lr.to(p.dtype)
        v = self.momentum * slots["velocity"] + g
        if self.use_nesterov:
            p.copy_(p - lr * (g + self.momentum * v))
        else:
            p.copy_(p - lr * v)
        slots["velocity"].copy_(v)


class LarsMomentum(Optimizer):
    """optimizer.py:165: layer-wise adaptive lr, local_lr = lr * coeff *
    ||p|| / (||g|| + weight_decay * ||p|| + epsilon)."""

    SLOTS = ("velocity",)

    def __init__(self, params, learning_rate: LR = 0.01,
                 momentum: float = 0.9, lars_coeff: float = 1e-3,
                 lars_weight_decay: float = 5e-4, epsilon: float = 1e-9,
                 **kw):
        super().__init__(params, learning_rate, **kw)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.lars_weight_decay = lars_weight_decay
        self.epsilon = epsilon

    def _apply_one(self, p, g, lr, step, slots):
        pf, gf = p.float(), g.float()
        p_norm = torch.sqrt(pf.square().sum())
        g_norm = torch.sqrt(gf.square().sum())
        local_lr = lr * self.lars_coeff * p_norm / (
            g_norm + self.lars_weight_decay * p_norm + self.epsilon)
        v = self.momentum * slots["velocity"] + local_lr * (
            gf + self.lars_weight_decay * pf)
        p.copy_((pf - v).to(p.dtype))
        slots["velocity"].copy_(v)


class Adagrad(Optimizer):
    """optimizer.py:195; the accumulator starts at
    `initial_accumulator_value`."""

    SLOTS = ("moment",)

    def __init__(self, params, learning_rate: LR = 0.01,
                 epsilon: float = 1e-6,
                 initial_accumulator_value: float = 0.0, **kw):
        super().__init__(params, learning_rate, **kw)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def init_slots(self, p):
        return {"moment": torch.full(p.shape, self.initial_accumulator_value,
                                     device=p.device)}

    def _apply_one(self, p, g, lr, step, slots):
        g = g.to(p.dtype)
        m = slots["moment"] + g.square()
        p.copy_(p - lr.to(p.dtype) * g / (torch.sqrt(m) + self.epsilon))
        slots["moment"].copy_(m)


class DecayedAdagrad(Optimizer):
    """optimizer.py:216: Adagrad over a decaying accumulator."""

    SLOTS = ("moment",)

    def __init__(self, params, learning_rate: LR = 0.01,
                 decay: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(params, learning_rate, **kw)
        self.decay = decay
        self.epsilon = epsilon

    def _apply_one(self, p, g, lr, step, slots):
        g = g.to(p.dtype)
        m = self.decay * slots["moment"] + (1 - self.decay) * g.square()
        p.copy_(p - lr.to(p.dtype) * g / (torch.sqrt(m) + self.epsilon))
        slots["moment"].copy_(m)


class Adam(Optimizer):
    """optimizer.py:235: bias-corrected Adam; `weight_decay` > 0 adds
    the decoupled (AdamW) term to the update."""

    SLOTS = ("m", "v")

    def __init__(self, params, learning_rate: LR = 0.001,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, weight_decay: float = 0.0, **kw):
        super().__init__(params, learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay

    def _apply_one(self, p, g, lr, step, slots):
        gf = g.float()
        t = _f32(step + 1)
        # in place, with JAX's roundings: beta * m, (1 - beta) * g, sum
        m = slots["m"].mul_(self.beta1).add_((1 - self.beta1) * gf)
        v = slots["v"].mul_(self.beta2).add_((1 - self.beta2) * gf.square())
        mhat = m / (1 - self.beta1 ** t)
        vhat = v / (1 - self.beta2 ** t)
        upd = mhat / (torch.sqrt(vhat) + self.epsilon)
        if self.weight_decay:
            upd = upd + self.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))


class AdamW(Adam):
    """Adam with decoupled weight decay 0.01 by default (optimizer.py:263)."""

    def __init__(self, params, learning_rate: LR = 0.001,
                 weight_decay: float = 0.01, **kw):
        super().__init__(params, learning_rate, weight_decay=weight_decay,
                         **kw)


class Adamax(Optimizer):
    """optimizer.py:268: Adam under the infinity norm."""

    SLOTS = ("m", "u")

    def __init__(self, params, learning_rate: LR = 0.001,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, **kw):
        super().__init__(params, learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _apply_one(self, p, g, lr, step, slots):
        gf = g.float()
        t = _f32(step + 1)
        m = self.beta1 * slots["m"] + (1 - self.beta1) * gf
        u = torch.maximum(self.beta2 * slots["u"], gf.abs())
        upd = lr / (1 - self.beta1 ** t) * m / (u + self.epsilon)
        p.copy_((p.float() - upd).to(p.dtype))
        slots["m"].copy_(m)
        slots["u"].copy_(u)


class Adadelta(Optimizer):
    """optimizer.py:288."""

    SLOTS = ("avg_sq_grad", "avg_sq_update")

    def __init__(self, params, learning_rate: LR = 1.0, rho: float = 0.95,
                 epsilon: float = 1e-6, **kw):
        super().__init__(params, learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon

    def _apply_one(self, p, g, lr, step, slots):
        gf = g.float()
        e_g = (self.rho * slots["avg_sq_grad"]
               + (1 - self.rho) * gf.square())
        upd = gf * torch.sqrt(slots["avg_sq_update"] + self.epsilon) / \
            torch.sqrt(e_g + self.epsilon)
        e_u = (self.rho * slots["avg_sq_update"]
               + (1 - self.rho) * upd.square())
        p.copy_((p.float() - lr * upd).to(p.dtype))
        slots["avg_sq_grad"].copy_(e_g)
        slots["avg_sq_update"].copy_(e_u)


class RMSProp(Optimizer):
    """optimizer.py:310 (centered and momentum variants); all three
    slots exist whatever the variant, as in JAX."""

    SLOTS = ("mean_sq", "mean_g", "mom")

    def __init__(self, params, learning_rate: LR = 0.01, rho: float = 0.95,
                 epsilon: float = 1e-6, momentum: float = 0.0,
                 centered: bool = False, **kw):
        super().__init__(params, learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def _apply_one(self, p, g, lr, step, slots):
        gf = g.float()
        ms = self.rho * slots["mean_sq"] + (1 - self.rho) * gf.square()
        if self.centered:
            mg = self.rho * slots["mean_g"] + (1 - self.rho) * gf
            denom = torch.sqrt(ms - mg.square() + self.epsilon)
        else:
            mg = slots["mean_g"]
            denom = torch.sqrt(ms + self.epsilon)
        mo = self.momentum * slots["mom"] + lr * gf / denom
        p.copy_((p.float() - mo).to(p.dtype))
        slots["mean_sq"].copy_(ms)
        slots["mean_g"].copy_(mg)
        slots["mom"].copy_(mo)


class Ftrl(Optimizer):
    """optimizer.py:339: follow the regularized leader."""

    SLOTS = ("squared", "linear")

    def __init__(self, params, learning_rate: LR = 0.01, l1: float = 0.0,
                 l2: float = 0.0, lr_power: float = -0.5, **kw):
        super().__init__(params, learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def _apply_one(self, p, g, lr, step, slots):
        pf, gf = p.float(), g.float()
        squared = slots["squared"]
        new_sq = squared + gf.square()
        lp = -self.lr_power
        sigma = (new_sq ** lp - squared ** lp) / lr
        lin = slots["linear"] + gf - sigma * pf
        quad = new_sq ** lp / lr + 2 * self.l2
        pre = torch.clamp(lin, -self.l1, self.l1) - lin
        new_p = torch.where(lin.abs() > self.l1, pre / quad,
                            torch.zeros_like(pf))
        p.copy_(new_p.to(p.dtype))
        slots["squared"].copy_(new_sq)
        slots["linear"].copy_(lin)


class ProximalGD(Optimizer):
    """optimizer.py:364: SGD with an l1/l2 proximal projection."""

    def __init__(self, params, learning_rate: LR = 0.01, l1: float = 0.0,
                 l2: float = 0.0, **kw):
        super().__init__(params, learning_rate, **kw)
        self.l1, self.l2 = l1, l2

    def _apply_one(self, p, g, lr, step, slots):
        prox = p.float() - lr * g.float()
        new_p = torch.sign(prox) * torch.clamp(
            prox.abs() - lr * self.l1, min=0.0) / (1.0 + lr * self.l2)
        p.copy_(new_p.to(p.dtype))


class ProximalAdagrad(Optimizer):
    """optimizer.py:379: Adagrad's adapted lr under the proximal
    projection."""

    SLOTS = ("moment",)

    def __init__(self, params, learning_rate: LR = 0.01, l1: float = 0.0,
                 l2: float = 0.0, **kw):
        super().__init__(params, learning_rate, **kw)
        self.l1, self.l2 = l1, l2

    def _apply_one(self, p, g, lr, step, slots):
        gf = g.float()
        m = slots["moment"] + gf.square()
        adapted_lr = lr / torch.sqrt(m + 1e-12)
        prox = p.float() - adapted_lr * gf
        new_p = torch.sign(prox) * torch.clamp(
            prox.abs() - adapted_lr * self.l1, min=0.0) / \
            (1.0 + adapted_lr * self.l2)
        p.copy_(new_p.to(p.dtype))
        slots["moment"].copy_(m)


class Lamb(Optimizer):
    """optimizer.py:401: Adam's update scaled by the layer's trust ratio
    ||p|| / ||update||."""

    SLOTS = ("m", "v")

    def __init__(self, params, learning_rate: LR = 0.001,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-6, weight_decay: float = 0.01, **kw):
        super().__init__(params, learning_rate, **kw)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon, self.weight_decay = epsilon, weight_decay

    def _apply_one(self, p, g, lr, step, slots):
        gf = g.float()
        t = _f32(step + 1)
        m = self.beta1 * slots["m"] + (1 - self.beta1) * gf
        v = self.beta2 * slots["v"] + (1 - self.beta2) * gf.square()
        mhat = m / (1 - self.beta1 ** t)
        vhat = v / (1 - self.beta2 ** t)
        upd = mhat / (torch.sqrt(vhat) + self.epsilon) + \
            self.weight_decay * p.float()
        w_norm = torch.sqrt(p.float().square().sum())
        u_norm = torch.sqrt(upd.square().sum())
        trust = torch.where(w_norm > 0, torch.where(
            u_norm > 0, w_norm / u_norm, 1.0), 1.0)
        p.copy_((p.float() - lr * trust * upd).to(p.dtype))
        slots["m"].copy_(m)
        slots["v"].copy_(v)


class ModelAverage:
    """optimizer.py:431: an exponential moving average of parameters for
    evaluation, in float32. `init(params)` copies them; `update(avg,
    params)` sets each average to decay * avg + (1 - decay) * p, in place,
    and returns `avg`."""

    def __init__(self, decay: float = 0.999):
        self.decay = decay

    def init(self, params: Iterable[torch.Tensor]) -> List[torch.Tensor]:
        return [p.detach().float().clone() for p in params]

    @torch.no_grad()
    def update(self, avg: List[torch.Tensor],
               params: Iterable[torch.Tensor]) -> List[torch.Tensor]:
        d = self.decay
        for a, p in zip(avg, params):
            a.copy_(d * a + (1 - d) * p.detach().float())
        return avg
