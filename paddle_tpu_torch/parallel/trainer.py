"""MeshTrainer, the single-device core (port of
paddle_tpu/parallel/trainer.py).

JAX compiles one SPMD step over a device mesh; the port's meshes span
one device (parallel/mesh.py), and its MeshTrainer is the port's
`Trainer` with the strategy's single-device knobs:

- the bad-step guard (`DistStrategy.bad_step_budget`): after the
  backward pass one fused isfinite check over the loss and every
  gradient and one host sync decide the step. A non-finite step calls
  no `optimizer.step()`, leaves `step` and the optimizer's step count
  where they were and copies back the module's persistent buffers from
  a copy taken before the forward pass — JAX's select-old on every
  leaf (:219-233), so a skipped step is a true no-op, not a
  zero-gradient Adam update. It emits `bad_step_skip`, and after
  `bad_step_budget` consecutive ones raises BadStepBudgetExceeded for a
  checkpoint rollback. A retried step keeps its step number, so it
  draws the same step generator (the same dropout);
- gradient accumulation (`gradient_accumulation_steps`): the batch's
  leading dim split into microbatches, each with its own generator
  derived from the step's, gradients summed in order and averaged, the
  loss the microbatches' mean (:185-212);
- loss scaling (`loss_scale`): the loss scaled, each gradient divided
  back (:164-171);
- step telemetry (`enable_metrics`, `put_batch`).

The state lives in the module and the optimizer, as in the port's
`Trainer`: `train_step(batch, generator=None) -> fetches`, `state()`,
`load_state()`, `eval_step(batch)`.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.core.executor import LossFn, Trainer, check_nan_inf
from paddle_tpu_torch.parallel.mesh import Mesh, make_mesh
from paddle_tpu_torch.parallel.strategy import DistStrategy, ReduceStrategy
from paddle_tpu_torch.resilience.errors import BadStepBudgetExceeded
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.log import resilience_event
from paddle_tpu_torch.utils.rng import fold_in
from paddle_tpu_torch.utils.tree import flatten_with_keys, map_leaves

_ITEM_10 = ("needs a mesh over several devices or a recompute pass "
            "(ROADMAP.md item 10)")


def _signature(batch) -> Tuple:
    """The batch's (key, shape, dtype) per leaf: what JAX keys its jit
    cache on."""
    return tuple((k, tuple(np.shape(x)), str(getattr(x, "dtype", type(x))))
                 for k, x in flatten_with_keys(batch))


def _split(batch, accum: int) -> List:
    """The batch as `accum` microbatches along each leaf's leading dim
    (scalars shared)."""
    def part(x, i):
        if np.ndim(x) == 0:
            return x
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch dim {b} does not split into "
                             f"{accum} microbatches")
        m = b // accum
        return x[i * m:(i + 1) * m]
    return [map_leaves(lambda x: part(x, i), batch) for i in range(accum)]


def _all_finite(loss: torch.Tensor, grads: List[torch.Tensor]) -> bool:
    """Whether the loss and every gradient element are finite: one
    fused check a (device, dtype) group of gradients (an elementwise
    isfinite, never a norm, which overflows to inf on large finite
    gradients) and one host sync."""
    found = torch.logical_not(torch.isfinite(loss.detach())).reshape(
        1).float()
    one = torch.ones(1, device=found.device)
    groups: Dict[Tuple, List[torch.Tensor]] = {}
    for g in grads:
        groups.setdefault((g.device, g.dtype), []).append(g)
    for gs in groups.values():
        # multiplies by 1 (exact) and sets `found` on any NaN or Inf
        torch._amp_foreach_non_finite_check_and_unscale_(gs, found, one)
    return not bool(found)


class MeshTrainer(Trainer):
    """Trains `module` on the one device of `mesh` (default: a mesh over
    the card; raises without one) under `strategy`. loss_fn has the
    port's `Trainer` contract: loss_fn(module, batch, generator,
    training) -> (loss, aux)."""

    def __init__(self, module: nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: LossFn, mesh: Optional[Mesh] = None,
                 strategy: Optional[DistStrategy] = None, seed: int = 0):
        super().__init__(module, optimizer, loss_fn, seed=seed)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.strategy = strategy or DistStrategy()
        st = self.strategy
        if st.reduce_strategy is ReduceStrategy.REDUCE:
            raise NotImplementedError(f"reduce_strategy=REDUCE {_ITEM_10}")
        if st.sequence_axis is not None:
            raise NotImplementedError(f"sequence_axis {_ITEM_10}")
        if st.remat:
            raise NotImplementedError(f"remat {_ITEM_10}")
        dev = self.mesh.device
        stray = [n for n, p in module.named_parameters() if p.device != dev]
        if stray:
            raise ValueError(f"parameters {stray[:3]} are not on the "
                             f"mesh's device {dev}")
        self._consecutive_bad = 0  # bad-step guard budget tracking
        self._signatures: set = set()
        # training telemetry families (None until enable_metrics())
        self._m_phase = None
        self._m_step = None
        self._g_compiles = None
        self._c_steps = None

    # -- telemetry --------------------------------------------------------
    def enable_metrics(self, registry=None) -> None:
        """Register the step-phase telemetry families and start timing.

        Instrumented steps synchronise the card once per step, so the
        `wait` phase is the device time left after the host has
        enqueued the step (`dispatch`; with the guard on, dispatch
        includes the guard's own sync on the forward and backward).
        `ptpu_train_compiles` counts the distinct (shape, dtype) batch
        signatures stepped: the programs JAX would have compiled, 1 on
        a fixed stream."""
        from paddle_tpu_torch.obs.metrics import default_registry
        reg = registry if registry is not None else default_registry()
        self._m_phase = reg.histogram(
            "ptpu_train_phase_ms",
            "Host wall time per training step phase",
            labelnames=("phase",))
        self._m_step = reg.histogram(
            "ptpu_train_step_ms",
            "Host wall time of one train_step call, dispatch to sync")
        self._g_compiles = reg.gauge(
            "ptpu_train_compiles",
            "Distinct batch signatures stepped (programs JAX compiles)")
        self._c_steps = reg.counter(
            "ptpu_train_steps_total", "Completed train_step calls")

    def _sync(self) -> None:
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

    # -- public API -------------------------------------------------------
    def put_batch(self, batch):
        """Host batch (numpy arrays, tensors, scalars) onto the mesh's
        device, timed as the `h2d` phase when metrics are on."""
        t0 = time.perf_counter()
        out = map_leaves(
            lambda x: torch.as_tensor(x).to(self.mesh.device), batch)
        if self._m_phase is not None:
            # sync so the observed h2d phase is the real transfer
            self._sync()
            self._m_phase.labels(phase="h2d").observe(
                (time.perf_counter() - t0) * 1e3)
        return out

    def _loss_and_grads(self, batch, generator, params: List[nn.Parameter]
                        ) -> Tuple[torch.Tensor, Dict, List[torch.Tensor]]:
        st = self.strategy
        accum, scale = st.gradient_accumulation_steps, st.loss_scale
        if accum <= 1:
            micro = [(batch, generator)]
        else:
            base = generator.initial_seed()
            micro = [(mb, fold_in(base, i, self.mesh.device))
                     for i, mb in enumerate(_split(batch, accum))]
        total, losses, auxes = None, [], []
        for mb, gen in micro:
            loss, aux = self.loss_fn(self.module, mb, gen, True)
            grads = torch.autograd.grad(loss * scale if scale else loss,
                                        params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            if scale:
                grads = [g / scale for g in grads]
            total = (grads if total is None
                     else [a + g for a, g in zip(total, grads)])
            losses.append(loss.detach())
            auxes.append(aux)
        if accum <= 1:
            return losses[0], auxes[0], total
        return (torch.stack(losses).mean(),
                {k: torch.stack([torch.as_tensor(a[k]) for a in auxes])
                 .mean() for k in auxes[0]},
                [g / accum for g in total])

    def train_step(self, batch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """One step. Returns {"loss": loss, **aux}, plus "bad_step" (a
        bool) with the guard on."""
        if generator is None:
            generator = self.step_generator()
        budget = self.strategy.bad_step_budget
        t0 = time.perf_counter()
        saved = (None if budget is None else
                 [b.detach().clone() for _, b in self._buffers()])
        self.module.train()
        self.optimizer.zero_grad(set_to_none=True)
        params = [p for p in self.module.parameters() if p.requires_grad]
        loss, aux, grads = self._loss_and_grads(batch, generator, params)
        bad = budget is not None and not _all_finite(loss, grads)
        if bad:
            with torch.no_grad():
                for (_, b), old in zip(self._buffers(), saved):
                    b.copy_(old)
        else:
            for p, g in zip(params, grads):
                p.grad = g
            self.optimizer.step()
            self.step += 1
        if self._m_phase is not None:
            t1 = time.perf_counter()
            self._m_phase.labels(phase="dispatch").observe((t1 - t0) * 1e3)
            self._sync()
            t2 = time.perf_counter()
            self._m_phase.labels(phase="wait").observe((t2 - t1) * 1e3)
            self._m_step.observe((t2 - t0) * 1e3)
            self._signatures.add(_signature(batch))
            self._g_compiles.set(len(self._signatures))
            self._c_steps.inc()
        fetches = {"loss": loss, **aux}
        if budget is not None:
            fetches["bad_step"] = bad
            if bad:
                self._consecutive_bad += 1
                resilience_event("bad_step_skip", step=self.step,
                                 consecutive=self._consecutive_bad,
                                 budget=budget)
                if self._consecutive_bad >= budget:
                    err = BadStepBudgetExceeded(budget, self.step)
                    # the trainer's state is the last GOOD one (the bad
                    # updates were skipped): the rollback's target
                    err.state = self.state()
                    raise err
            else:
                self._consecutive_bad = 0
        if FLAGS.get("check_nan_inf"):
            check_nan_inf(fetches, "train fetches")
        return fetches

    def reset_bad_steps(self) -> None:
        """Zero the consecutive-bad-step counter (after a rollback)."""
        self._consecutive_bad = 0
