"""The single-device training engine (port of paddle_tpu/core/executor.py
`Trainer` and `supervised_loss`).

    trainer = Trainer(model, Adam(model.parameters(), 1e-3), loss_fn)
    fetches = trainer.train_step(batch)       # {"loss": ..., **aux}

`loss_fn(module, batch, generator, training) -> (loss, aux)` keeps the
shape of JAX's loss function, with the module in place of its variables
and a `torch.Generator` in place of the rng: every dropout of the step
draws from it. `train_step` runs the forward and backward eagerly and
updates the module's parameters and the optimizer's slots IN PLACE (JAX
returns a new TrainState).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]


class Trainer:
    """Trains `module` with `optimizer` (built over the module's
    parameters) under `loss_fn`. `step` counts the steps taken."""

    def __init__(self, module: nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: LossFn, seed: int = 0):
        self.module = module
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.seed = seed
        self.step = 0

    def _device(self) -> torch.device:
        return next(self.module.parameters()).device

    def step_generator(self) -> torch.Generator:
        """The default generator of the current step, seeded from
        (seed ^ 0x5EED, step) as JAX folds the step into
        key(seed ^ 0x5EED) (executor.py:170-173). The bits differ from
        JAX's; the stream is as reproducible: the same seed and step give
        the same dropout."""
        gen = torch.Generator(device=self._device())
        # the CPU generator seeds from the low 32 bits only: both parts
        # must reach them (1000003 is odd, so distinct seeds stay apart)
        key = ((self.seed ^ 0x5EED) & 0xFFFFFFFF) * 1000003 + self.step
        gen.manual_seed(key & 0xFFFFFFFFFFFFFFFF)
        return gen

    def train_step(self, batch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """One step: forward in training mode, backward, optimizer
        update. Returns {"loss": loss, **aux} (loss detached)."""
        if generator is None:
            generator = self.step_generator()
        self.module.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss_fn(self.module, batch, generator, True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach(), **aux}

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, Any]:
        """The loss and aux in eval mode (no dropout, no update)."""
        self.module.eval()
        loss, aux = self.loss_fn(self.module, batch, None, False)
        return {"loss": loss, **aux}

    def fit(self, data: Iterable, epochs: int = 1,
            callback: Optional[Callable[[int, Dict], None]] = None) -> None:
        """Epoch loop over `data`'s batches; `callback(step, fetches)`
        after each step."""
        for _ in range(epochs):
            for batch in data:
                fetches = self.train_step(batch)
                if callback is not None:
                    callback(self.step, fetches)


def supervised_loss(criterion: Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor],
                    metrics: Optional[Dict[str, Callable]] = None) -> LossFn:
    """The standard loss_fn (executor.py:245): mean criterion of
    `module(x, generator=generator)` against labels, plus metrics.
    Batches are an (inputs, labels) pair or {"image": ..., "label": ...}."""
    metrics = metrics or {}

    def loss_fn(module, batch, generator, training):
        if isinstance(batch, dict):
            x, y = batch["image"], batch["label"]
        else:
            x, y = batch
        out = module(x, generator=generator)
        loss = torch.mean(criterion(out, y))
        aux = {name: fn(out, y) for name, fn in metrics.items()}
        return loss, aux

    return loss_fn
