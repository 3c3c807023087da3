"""MeshTrainer: training over a mesh of ranks (port of
paddle_tpu/parallel/trainer.py).

JAX compiles one SPMD step and XLA's partitioner places every
collective. The port runs one process a rank (parallel/mesh.py) and
keeps the partitioner's contract by hand:

1. Rank coordinates. Rank r sits at `np.unravel_index(r, shape)` in
   AXIS_ORDER, where JAX puts `jax.devices()[r]`, and holds the slices
   JAX's device r holds.
2. Storage. Every leaf — parameter, optimizer slot (slots follow their
   parameter, so REDUCE under `fsdp_rules` is a true ZeRO: parameters,
   gradients and moments all sharded) — is stored as the rules place it
   (`shard_module`, at construction); an axis of size 1 leaves its dim
   whole. The optimizer steps on the shards. Persistent buffers
   (BatchNorm's running statistics) stay whole.
3. Gradients after backward, on every rank: a leaf whole across tp has
   the same gradient on every tp rank; a tp-sharded leaf the gradient of
   the rank's own slice. The trainer then averages over the batch axes
   only (`DistStrategy.batch_axes`, default ("dp", "fsdp")), which gives
   JAX's global-mean loss: all-reduce mean in flat buckets over the
   batch axes a leaf is not sharded on (a leaf sharded on a batch axis
   gets its reduce-scatter mean from rule 4).
4. Gather on use. A leaf the forward needs whole (an fsdp leaf, a
   vocab-sharded embedding) is all-gathered for the step and freed with
   the backward's graph. The gather's backward over a batch axis is the
   reduce-scatter mean; over an axis the compute is replicated on (tp,
   for a gathered embedding) the rank's own slice, with no sum
   (collective.gather_for_use).
5. Megatron tp inside the model: a layer that declares `local_specs()`
   (the transformer's attention and FFN, ShardedEmbedding, the stage
   stacks of parallel/pipeline.py) consumes those parameters at their
   local width; the rules must place them so (`transformer_tp_rules`,
   `pipeline_rules`), or the trainer refuses. A stage stack is consumed
   at ("pp", ...): a rank keeps its v stages and gathers nothing. Column-parallel
   inputs go through copy_to_axis (identity forward, all-reduce-sum
   backward), row-parallel outputs through reduce_from_axis (all-reduce
   sum forward, identity backward), with the row bias added once after
   the reduce. transformer_tp_rules keeps every bias whole, so a
   column-parallel layer adds its slice of a whole bias through
   copy_to_axis: the zero-padded slice gradient is summed over tp, and
   the whole bias ends with its full gradient on every tp rank.
6. The bad-step guard decides once for the world: each rank's fused
   isfinite flag is all-reduced with max over every rank before the
   host reads it, so every rank skips the same step.

The layers find the mesh through `current_mesh()`: train_step and
eval_step run inside `with mesh:`. The sp, pp and ep axes are the loss
function's business (parallel/pipeline.py's `pipelined_lm_loss` and
`pipelined_moe_lm_loss`): it adds the sums over them that its
replicated leaves need, and `sequence_axis` is read by nothing, as in
JAX.

On top of the port's `Trainer` (`train_step(batch, generator=None)`,
`state()`, `load_state()`, `eval_step(batch)`), the strategy's knobs:

- the bad-step guard (`bad_step_budget`): a non-finite step calls no
  `optimizer.step()`, leaves `step` and the optimizer's step count where
  they were and copies back the persistent buffers taken before the
  forward pass — JAX's select-old on every leaf (:219-233). It emits
  `bad_step_skip`, and after `bad_step_budget` consecutive ones raises
  BadStepBudgetExceeded for a checkpoint rollback;
- gradient accumulation (`gradient_accumulation_steps`): the rank's
  batch (put by `put_batch` / `batch_sharding()`, so microbatch i is
  this rank's slice of JAX's global microbatch i) split into
  microbatches, each with its generator folded from the step's,
  gradients summed in order and averaged (:185-212);
- loss scaling (`loss_scale`): the loss scaled, each gradient divided
  back (:164-171);
- `remat`: the loss function under torch.utils.checkpoint
  (non-reentrant), as jax.checkpoint at :153-156. Checkpoint replays
  the default generators only, so every forward draws from a generator
  rebuilt from the step generator's state, the recomputed one too:
  remat and no-remat give the same bits. The persistent buffers the
  recomputed forward moves again are put back after the backward;
- dropout across ranks: each rank folds its coordinate over the batch
  axes into the step generator, so the masks differ across the ranks
  that hold different data and repeat for a given seed and mesh (JAX's
  global PRNG gives a sharded run the single-device masks; the port
  cannot). Inside the tp region (a rank's heads, its FFN columns) the
  model folds the tp coordinate in as well (models/transformer.py's
  `_tp_generator`); dropout on replicated activations draws the same
  mask on every tp rank;
- step telemetry (`enable_metrics`, `put_batch`).

`state()` gives this rank's pieces (sharding.Piece: the data, the
leaf's global shape and index, and whether this rank writes it), the
form the checkpoint writer and `load_checkpoint(path, target=...)`
take; `load_state` takes them back (or whole leaves, which it cuts).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.core.executor import (LossFn, Trainer, TrainState,
                                            check_nan_inf)
from paddle_tpu_torch.models.convert import param_path
from paddle_tpu_torch.parallel import collective as C
from paddle_tpu_torch.parallel.mesh import Mesh, batch_axes_scope, make_mesh
from paddle_tpu_torch.parallel.sharding import (BatchSharding, Piece,
                                                ShardingRules, _fit_spec,
                                                _entry_axes, fsdp_rules,
                                                local_index, shard_module)
from paddle_tpu_torch.parallel.strategy import DistStrategy, ReduceStrategy
from paddle_tpu_torch.profiler.profiler import RecordEvent
from paddle_tpu_torch.resilience.errors import BadStepBudgetExceeded
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.log import resilience_event
from paddle_tpu_torch.utils.rng import fold_in
from paddle_tpu_torch.utils.tree import flatten_with_keys, map_leaves, nest

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


def _all_finite(loss: torch.Tensor, grads: List[torch.Tensor],
                world: Optional[C.AxisGroup] = None) -> bool:
    """Whether the loss and every gradient element are finite: one
    fused check a (device, dtype) group of gradients (an elementwise
    isfinite, never a norm, which overflows to inf on large finite
    gradients), max-reduced over `world` when given, and one host
    sync."""
    found = torch.logical_not(torch.isfinite(loss.detach())).reshape(
        1).float()
    one = torch.ones(1, device=found.device)
    groups: Dict[Tuple, List[torch.Tensor]] = {}
    for g in grads:
        groups.setdefault((g.device, g.dtype), []).append(g)
    for gs in groups.values():
        # multiplies by 1 (exact) and sets `found` on any NaN or Inf
        torch._amp_foreach_non_finite_check_and_unscale_(gs, found, one)
    if world is not None:
        found = C.all_reduce(found, world, "max")
    return not bool(found)


def _sum_sq(held: Dict[int, Tuple[str, ...]], mesh: Mesh,
            params: List[torch.Tensor],
            squares: List[torch.Tensor]) -> List[torch.Tensor]:
    """The optimizer's `sum_sq` hook: each gradient's squared sum over
    its whole leaf, a shard's all-reduced over the axes its leaf is
    sharded on (`held`, by the parameter's id), one call a set of
    axes."""
    by_axes: Dict[Tuple, List[int]] = {}
    for i, p in enumerate(params):
        if id(p) in held:
            by_axes.setdefault(held[id(p)], []).append(i)
    out = list(squares)
    for axes, idx in by_axes.items():
        total = C.all_reduce(torch.stack([squares[i].float() for i in idx]),
                             mesh.group(axes))
        for i, v in zip(idx, total):
            out[i] = v.to(squares[i].dtype)
    return out


class _Plan:
    """How one parameter lives on the mesh: its rule `spec` (axes of
    size 1 dropped), global `shape`, this rank's `index` and `owner`
    flag, the `gathers` (axis, dim, batch) that make it whole for use,
    and the batch axes its gradient is averaged over (`reduce`)."""

    __slots__ = ("path", "spec", "shape", "index", "owner", "gathers",
                 "reduce")


def _owner_of(mesh: Mesh, spec: Tuple) -> bool:
    held = {a for e in spec for a in _entry_axes(e)}
    coords = mesh.coords
    return all(coords[a] == 0 for a in mesh.wide() if a not in held)


@contextlib.contextmanager
def _swapped(module: nn.Module, tensors: Dict[str, torch.Tensor]):
    """`module`'s parameters named in `tensors` read as those tensors
    while open (the gathered whole of a shard); restored after."""
    saved = []
    for name, t in tensors.items():
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        saved.append((owner, attr, owner._parameters[attr]))
        owner._parameters[attr] = t
    try:
        yield
    finally:
        for owner, attr, p in saved:
            owner._parameters[attr] = p


class MeshTrainer(Trainer):
    """Trains `module` (built whole on this rank's device, the same
    weights on every rank) over `mesh` (default: a mesh over the card;
    raises without one) under `strategy`, placing its leaves by `rules`
    (default: `fsdp_rules()` under REDUCE, else everything whole).
    loss_fn has the port's `Trainer` contract: loss_fn(module, batch,
    generator, training) -> (loss, aux)."""

    def __init__(self, module: nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: LossFn, mesh: Optional[Mesh] = None,
                 strategy: Optional[DistStrategy] = None,
                 rules: Optional[ShardingRules] = None, seed: int = 0):
        super().__init__(module, optimizer, loss_fn, seed=seed)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.strategy = strategy or DistStrategy()
        st = self.strategy
        if rules is None:
            rules = (fsdp_rules() if st.reduce_strategy is
                     ReduceStrategy.REDUCE else ShardingRules())
        self.rules = rules
        dev = self.mesh.device
        stray = [n for n, p in module.named_parameters() if p.device != dev]
        if stray:
            raise ValueError(f"parameters {stray[:3]} are not on the "
                             f"mesh's device {dev}")
        self.batch_axes = self.mesh.wide(st.batch_axes)
        self._plans = self._make_plans()
        shard_module(module, rules, mesh=self.mesh)
        # each sharded parameter's axes: norm clipping sums its gradient's
        # squares over them (the optimizer's `sum_sq` hook; a partial,
        # not a bound method, so the optimizer holds no reference back
        # to the trainer and a dropped trainer frees its tensors at once)
        held = {id(p): ax for n, p in module.named_parameters()
                if (ax := tuple(a for e in self._plans[n].spec
                                for a in _entry_axes(e)))}
        if held and hasattr(optimizer, "sum_sq"):
            optimizer.sum_sq = functools.partial(_sum_sq, held, self.mesh)
        self._consecutive_bad = 0  # bad-step guard budget tracking
        self._signatures: set = set()
        # training telemetry families (None until enable_metrics())
        self._m_phase = None
        self._m_step = None
        self._g_compiles = None
        self._c_steps = None

    # -- placement ----------------------------------------------------------
    def _local_specs(self) -> Dict[str, Tuple]:
        """{parameter name: spec it is consumed at} of every layer that
        declares one (`local_specs()`), axes of size 1 dropped."""
        out = {}
        for mname, m in self.module.named_modules():
            fn = getattr(m, "local_specs", None)
            if fn is None:
                continue
            for pname, spec in fn().items():
                out[f"{mname}.{pname}" if mname else pname] = spec
        return out

    def _wide_spec(self, spec: Tuple) -> Tuple:
        def keep(entry):
            names = tuple(a for a in _entry_axes(entry)
                          if self.mesh.shape.get(a, 1) > 1)
            return None if not names else (
                names[0] if len(names) == 1 else names)
        return tuple(keep(e) for e in spec)

    def _make_plans(self) -> Dict[str, _Plan]:
        mesh, local = self.mesh, self._local_specs()
        coords, sizes = mesh.coords, mesh.shape
        plans = {}
        for name, p in self.module.named_parameters():
            shape = tuple(p.shape)
            plan = _Plan()
            plan.path = param_path(name)
            plan.shape = shape
            plan.spec = self._wide_spec(
                self.rules.spec_for(plan.path, shape))
            want = self._wide_spec(_fit_spec(local.get(name, ()), shape))
            plan.index = local_index(plan.spec, shape, coords, sizes)
            plan.owner = _owner_of(mesh, plan.spec)
            plan.gathers = []
            for dim, (got, use) in enumerate(zip(plan.spec, want)):
                if use is not None and got != use:
                    raise ValueError(
                        f"{plan.path}: the model consumes dim {dim} "
                        f"sharded over {use!r}, the rules place it as "
                        f"{plan.spec} (tensor parallelism needs "
                        "transformer_tp_rules, pipeline stages "
                        "pipeline_rules or pipeline_moe_rules)")
                if got is None or use is not None:
                    continue
                for axis in reversed(_entry_axes(got)):
                    plan.gathers.append((axis, dim, axis in self.batch_axes))
            held = {a for e in plan.spec for a in _entry_axes(e)}
            plan.reduce = tuple(a for a in self.batch_axes if a not in held)
            plans[name] = plan
        return plans

    def batch_sharding(self) -> BatchSharding:
        """The leading-dim batch placement over the strategy's batch axes
        (with its microbatch layout): `device_prefetch` and `DataFeeder`
        take it as `sharding=`."""
        return BatchSharding(self.mesh, self.strategy.batch_axes,
                             self.strategy.gradient_accumulation_steps)

    def state_shardings(self) -> TrainState:
        """The spec of every leaf of `state()`, in a TrainState of the
        same structure: a parameter's from the rules (axes of size 1
        dropped), each optimizer slot its parameter's, persistent
        buffers and the step counts whole."""
        params = nest({pl.path: pl.spec for pl in self._plans.values()})
        return TrainState(
            params=params,
            state=nest({param_path(n): (None,) * b.dim()
                        for n, b in self._buffers()}),
            opt_state={"step": (), "slots": {s: params for s in
                                             self.optimizer.SLOTS}},
            step=())

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
        """The global host batch (numpy arrays, tensors, scalars): this
        rank's slice over the batch axes (`batch_sharding()`), on its
        device, timed as the `h2d` phase when metrics are on."""
        t0 = time.perf_counter()
        sh = self.batch_sharding()
        out = map_leaves(
            lambda x: torch.as_tensor(sh.local(x)).to(self.mesh.device),
            batch)
        if self._m_phase is not None:
            # sync so the observed h2d phase is the real transfer
            self._sync()
            self._m_phase.labels(phase="h2d").observe(
                (time.perf_counter() - t0) * 1e3)
        return out

    def _rank_generator(self, generator: torch.Generator
                        ) -> torch.Generator:
        """The step generator with this rank's batch coordinate folded
        in (the generator as it is without multi-rank batch axes)."""
        if not self.batch_axes:
            return generator
        coords, sizes = self.mesh.coords, self.mesh.shape
        k = 0
        for a in self.batch_axes:
            k = k * sizes[a] + coords[a]
        return fold_in(generator.initial_seed(), k, generator.device)

    def _use_tensors(self) -> Dict[str, torch.Tensor]:
        """The whole tensors of the gathered parameters, by name: the
        k-th gather of every parameter that has one in a round, one
        bucketed gather_for_use for each (axis, batch) of the round."""
        cur = {n: p for n, p in self.module.named_parameters()
               if self._plans[n].gathers}
        rounds = max((len(self._plans[n].gathers) for n in cur), default=0)
        for k in range(rounds):
            groups: Dict[Tuple, List[Tuple[str, int]]] = {}
            for n in cur:
                gathers = self._plans[n].gathers
                if k < len(gathers):
                    axis, dim, batch = gathers[k]
                    groups.setdefault((axis, batch), []).append((n, dim))
            for (axis, batch), items in groups.items():
                done = C.gather_for_use([cur[n] for n, _ in items],
                                        self.mesh.group(axis),
                                        [d for _, d in items], batch)
                cur.update(zip([n for n, _ in items], done))
        return cur

    def _micro(self, mb, generator: torch.Generator,
               params: List[nn.Parameter]):
        """(loss, aux, grads) of one microbatch. Every forward draws from
        a generator rebuilt from `generator`'s state, so a recomputed
        forward draws the same bits."""
        state, device = generator.get_state(), generator.device
        scale = self.strategy.loss_scale

        def run():
            gen = torch.Generator(device=device)
            gen.set_state(state)
            with _swapped(self.module, self._use_tensors()):
                return self.loss_fn(self.module, mb, gen, True)

        if not self.strategy.remat:
            loss, aux = run()
            grads = torch.autograd.grad(loss * scale if scale else loss,
                                        params, allow_unused=True)
        else:
            from torch.utils.checkpoint import checkpoint
            loss, aux = checkpoint(run, use_reentrant=False)
            moved = [b.detach().clone() for _, b in self._buffers()]
            grads = torch.autograd.grad(loss * scale if scale else loss,
                                        params, allow_unused=True)
            with torch.no_grad():   # the recompute moved them again
                for (_, b), v in zip(self._buffers(), moved):
                    b.copy_(v)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if scale:
            grads = [g / scale for g in grads]
        return loss.detach(), aux, grads

    def _loss_and_grads(self, batch, generator, params: List[nn.Parameter]
                        ) -> Tuple[torch.Tensor, Dict, List[torch.Tensor]]:
        accum = self.strategy.gradient_accumulation_steps
        if accum <= 1:
            micro = [(batch, generator)]
        else:
            base = generator.initial_seed()
            micro = [(mb, fold_in(base, i, generator.device))
                     for i, mb in enumerate(_split(batch, accum))]
        total, losses, auxes = None, [], []
        for mb, gen in micro:
            loss, aux, grads = self._micro(mb, gen, params)
            total = (grads if total is None
                     else [a + g for a, g in zip(total, grads)])
            losses.append(loss)
            auxes.append(aux)
        if accum <= 1:
            return losses[0], auxes[0], total
        return (torch.stack(losses).mean(),
                {k: torch.stack([torch.as_tensor(a[k]) for a in auxes])
                 .mean() for k in auxes[0]},
                [g / accum for g in total])

    def _reduce_grads(self, names: List[str],
                      grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Average every gradient over the batch axes it is not sharded
        on, in flat buckets, one bucket set a group of axes."""
        by_key: Dict[Tuple, List[int]] = {}
        for i, n in enumerate(names):
            key = self._plans[n].reduce
            if key:
                by_key.setdefault(key, []).append(i)
        out = list(grads)
        for key in sorted(by_key):
            idx = by_key[key]
            done = C.all_reduce_buckets([grads[i] for i in idx],
                                        self.mesh.group(key), "mean")
            for i, g in zip(idx, done):
                out[i] = g
        return out

    def _global_mean(self, fetches: Dict[str, Any]) -> Dict[str, Any]:
        """The rank-local loss and aux averaged over the batch axes (JAX's
        fetches are global means)."""
        if not self.batch_axes:
            return fetches
        group = self.mesh.group(self.batch_axes)
        keys = [k for k, v in fetches.items()
                if isinstance(v, torch.Tensor) and v.is_floating_point()
                and v.dim() == 0]
        if not keys:
            return fetches
        vals = C.all_reduce(torch.stack([fetches[k].detach().float()
                                         for k in keys]), group, "mean")
        return {**fetches, **{k: v.to(fetches[k].dtype)
                              for k, v in zip(keys, vals)}}

    def train_step(self, batch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """One step. Returns {"loss": loss, **aux} (the global means over
        the batch axes), plus "bad_step" (a bool) with the guard on."""
        if generator is None:
            generator = self.step_generator()
        generator = self._rank_generator(generator)
        budget = self.strategy.bad_step_budget
        t0 = time.perf_counter()
        saved = (None if budget is None else
                 [b.detach().clone() for _, b in self._buffers()])
        self.module.train()
        self.optimizer.zero_grad(set_to_none=True)
        named = [(n, p) for n, p in self.module.named_parameters()
                 if p.requires_grad]
        params = [p for _, p in named]
        with RecordEvent("MeshTrainer.train_step"), self.mesh, \
                batch_axes_scope(self.batch_axes):
            loss, aux, grads = self._loss_and_grads(batch, generator,
                                                    params)
            grads = self._reduce_grads([n for n, _ in named], grads)
            world = (self.mesh.group(self.mesh.wide())
                     if self.mesh.wide() else None)
            bad = budget is not None and not _all_finite(loss, grads, world)
            if bad:
                with torch.no_grad():
                    for (_, b), old in zip(self._buffers(), saved):
                        b.copy_(old)
            else:
                for p, g in zip(params, grads):
                    p.grad = g
                self.optimizer.step()
                self.step += 1
            fetches = self._global_mean({"loss": loss, **aux})
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

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, Any]:
        """The loss and aux in eval mode (no dropout, no update), global
        means over the batch axes. The shards are gathered for the
        forward and dropped with it: the state stays sharded."""
        self.module.eval()
        with self.mesh, batch_axes_scope(self.batch_axes), \
                _swapped(self.module, self._use_tensors()):
            loss, aux = self.loss_fn(self.module, batch, None, False)
            return self._global_mean({"loss": loss, **aux})

    # -- state ----------------------------------------------------------
    def _multi(self) -> bool:
        return self.mesh.size > 1

    def state(self) -> TrainState:
        """A `TrainState` view of this rank's leaves. On a mesh of
        several ranks every parameter and slot leaf is a `Piece` (the
        rank's data, the global shape, its index, whether it writes the
        piece) and the buffers are Pieces of the whole, written by rank
        0; the live tensors are the pieces' data, which the next step
        updates in place."""
        ts = super().state()
        if not self._multi():
            return ts
        by_path = {pl.path: pl for pl in self._plans.values()}

        def wrap(path, t):
            pl = by_path[path]
            return Piece(t, pl.shape, pl.index, pl.owner)

        def wrap_tree(tree):
            return nest({k: wrap(k, t) for k, t in flatten_with_keys(tree)})

        root = self.mesh.rank == 0
        return TrainState(
            params=wrap_tree(ts.params),
            state=nest({k: Piece(t, t.shape, (slice(None),) * t.dim(),
                                 root)
                        for k, t in flatten_with_keys(ts.state)}),
            opt_state={"step": ts.opt_state["step"],
                       "slots": {s: wrap_tree(tree) for s, tree in
                                 ts.opt_state["slots"].items()}},
            step=ts.step)

    @torch.no_grad()
    def load_state(self, ts: TrainState) -> None:
        """Copy a `TrainState` into the module, the optimizer and `step`
        in place: Pieces (as `state()` and `load_checkpoint(path,
        target=trainer.state())` give them), or whole leaves, which are
        cut to this rank's slices."""
        by_path = {pl.path: pl for pl in self._plans.values()}

        def local(path_of, leaf):
            data = leaf.data if isinstance(leaf, Piece) else leaf
            pl = by_path.get(path_of)
            if pl is not None and tuple(np.shape(data)) == pl.shape \
                    and pl.shape != tuple(
                        len(range(*s.indices(d)))
                        for s, d in zip(pl.index, pl.shape)):
                data = data[pl.index]
            return data

        def tree_local(tree):
            return nest({k: local(k, v) for k, v in
                         flatten_with_keys(tree)})

        state = nest({k: (v.data if isinstance(v, Piece) else v)
                      for k, v in flatten_with_keys(ts.state)})
        opt = ts.opt_state
        super().load_state(TrainState(
            params=tree_local(ts.params), state=state,
            opt_state={"step": opt["step"],
                       "slots": {s: tree_local(t)
                                 for s, t in opt["slots"].items()}},
            step=ts.step))
