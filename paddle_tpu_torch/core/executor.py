"""The single-device runtime (port of paddle_tpu/core/executor.py):
`Trainer`, `TrainState`, `supervised_loss`, the NaN/Inf guard and the
`Executor` / `NaiveExecutor` program runners.

    trainer = Trainer(model, Adam(model.parameters(), 1e-3), loss_fn)
    fetches = trainer.train_step(batch)       # {"loss": ..., **aux}
    manager.save(trainer.state(), step=trainer.step)
    ts, _ = manager.restore_latest(target=trainer.state())
    trainer.load_state(ts)

`loss_fn(module, batch, generator, training) -> (loss, aux)` keeps the
shape of JAX's loss function, with the module in place of its variables
and a `torch.Generator` in place of the rng: every dropout of the step
draws from it. `train_step` runs the forward and backward eagerly and
updates the module's parameters and the optimizer's slots IN PLACE (JAX
returns a new TrainState); `Trainer.state()` is a `TrainState` view
over them, keyed as JAX keys its own, so a checkpoint of it loads in
either package.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import OrderedDict
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.models.convert import (load_jax_opt_state,
                                             load_jax_params, param_path,
                                             persistent_buffers)
from paddle_tpu_torch.profiler.profiler import RecordEvent
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.rng import fold_in
from paddle_tpu_torch.utils.tree import flatten_with_keys, nest

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]


class ExecutorError(Exception):
    pass


def check_nan_inf(tree, what: str = "outputs") -> None:
    """Debug guard (executor.py:47): raise FloatingPointError naming the
    first floating leaf of `tree` that holds a NaN or an Inf. Reads the
    values on the host, so it synchronises with the card: debug only."""
    for name, leaf in flatten_with_keys(tree):
        if isinstance(leaf, torch.Tensor):
            bad = (leaf.is_floating_point()
                   and not bool(torch.isfinite(leaf).all()))
        else:
            arr = np.asarray(leaf)
            bad = (np.issubdtype(arr.dtype, np.floating)
                   and not bool(np.isfinite(arr).all()))
        if bad:
            raise FloatingPointError(
                f"NaN/Inf detected in {what} at {name!r}")


@dataclasses.dataclass
class TrainState:
    """All mutable training quantities as one tree (executor.py:68):
    `params` and `state` (persistent buffers) keyed like the JAX
    module's collections, `opt_state` = {"step", "slots": {name: tree}}
    and the global `step`. Flattened (utils/tree.py) its keys are JAX's:
    `0/...`, `1/...`, `2/slots/...`, `2/step`, `3`."""
    params: Any
    state: Any
    opt_state: Any
    step: torch.Tensor

    @property
    def variables(self) -> Dict[str, Any]:
        return {"params": self.params, "state": self.state}


def host_step_of(ts: TrainState) -> int:
    """ts.step as a Python int (executor.py:100). The port keeps the step
    on the host (a CPU tensor), so this never waits for the card."""
    return int(ts.step)


def _param_tree(module: nn.Module) -> Dict:
    """The module's parameters, live (detached views), keyed like JAX's
    `params` collection."""
    return nest({param_path(n): p.detach()
                 for n, p in module.named_parameters()})


class Trainer:
    """Trains `module` with `optimizer` (one of the port's optimizers,
    built over the module's parameters) under `loss_fn`. `step` counts
    the steps taken."""

    def __init__(self, module: nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: LossFn, seed: int = 0):
        self.module = module
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.seed = seed
        self.step = 0

    def _device(self) -> torch.device:
        return next(self.module.parameters()).device

    def _buffers(self) -> List[Tuple[str, torch.Tensor]]:
        """The module's persistent buffers (its JAX `state`)."""
        return persistent_buffers(self.module)

    def step_generator(self) -> torch.Generator:
        """The default generator of the current step, seeded from
        (seed ^ 0x5EED, step) as JAX folds the step into
        key(seed ^ 0x5EED) (executor.py:170-173). The bits differ from
        JAX's; the stream is as reproducible: the same seed and step give
        the same dropout."""
        return fold_in(self.seed ^ 0x5EED, self.step, self._device())

    def state(self) -> TrainState:
        """A `TrainState` VIEW of the module's parameters and persistent
        buffers, the optimizer's slots (made now if no step has made them
        yet) and the step counts. The tensors are the live ones, which
        the next step updates in place: snapshot them (save_checkpoint
        does) before stepping on."""
        opt = self.optimizer
        named = list(self.module.named_parameters())
        slots = {s: nest({param_path(n): opt.slots_of(p)[s]
                          for n, p in named})
                 for s in opt.SLOTS}
        return TrainState(
            params=_param_tree(self.module),
            state=nest({param_path(n): b.detach()
                        for n, b in self._buffers()}),
            opt_state={"step": torch.tensor(opt.step_count,
                                            dtype=torch.int32),
                       "slots": slots},
            step=torch.tensor(self.step, dtype=torch.int32))

    @torch.no_grad()
    def load_state(self, ts: TrainState) -> None:
        """Copy a `TrainState` (tensor or numpy leaves, e.g. a restored
        checkpoint) into the module, the optimizer and `step`, in place.
        Restoring `step` restores the step's default generator too."""
        load_jax_params(self.module, {"params": ts.params,
                                      "state": ts.state})
        load_jax_opt_state(self.module, self.optimizer, ts.opt_state)
        self.step = int(ts.step)

    def train_step(self, batch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """One step: forward in training mode, backward, optimizer
        update. Returns {"loss": loss, **aux} (loss detached). Under
        FLAGS_check_nan_inf the fetches and the new parameters are
        checked (executor.py:212-214)."""
        if generator is None:
            generator = self.step_generator()
        with RecordEvent("Trainer.train_step"):
            self.module.train()
            self.optimizer.zero_grad(set_to_none=True)
            loss, aux = self.loss_fn(self.module, batch, generator, True)
            loss.backward()
            self.optimizer.step()
            self.step += 1
        fetches = {"loss": loss.detach(), **aux}
        if FLAGS.get("check_nan_inf"):
            check_nan_inf(fetches, "train fetches")
            check_nan_inf(_param_tree(self.module), "params")
        return fetches

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


def train_from_files(trainer: Trainer, files: Sequence[str], slots,
                     batch_fn: Optional[Callable] = None, *,
                     batch_size: int = 128, nthreads: int = 2,
                     epochs: int = 1, prefetch: int = 2,
                     max_sparse_len: Optional[int] = None,
                     drop_last: bool = True,
                     callback: Optional[Callable[[int, Dict], None]] = None,
                     native: Optional[bool] = None) -> TrainState:
    """Train straight from slot-format text files (executor.py:267).

    The AsyncExecutor.RunFromFile capability (Fluid's
    framework/async_executor.cc: training threads consume a DataFeed
    without returning to Python between examples): the native
    `MultiSlotDataFeed` parses the files on C++ threads, sparse slots
    become the padded + mask form of static shape (`to_padded`, at
    `max_sparse_len`), and `data.feeder.device_prefetch` keeps
    `prefetch` batches in flight onto the trainer's device (pinned,
    non-blocking copies on the card), so parsing and copies overlap
    the step.

    `batch_fn(batch_dict) -> model batch` adapts a columnar batch (dense
    slots: arrays; sparse slots: (padded, mask)) on the host to the
    trainer's batch convention; by default the dict passes through.
    With `drop_last` the ragged tail batch is dropped, so every step
    has one shape. `native` goes to the feed (None: the C++ parser when
    it builds; True: raise when it does not). The trainer holds its
    state, as in `Trainer.fit`: `callback(step, fetches)` after each
    step, and the return is `trainer.state()`.
    """
    from paddle_tpu_torch.data.datafeed import (MultiSlotDataFeed,
                                                _batch_rows, to_padded)
    from paddle_tpu_torch.data.feeder import device_prefetch

    feed = MultiSlotDataFeed(files, slots, batch_size=batch_size,
                             nthreads=nthreads, native=native)
    sparse = [s.name for s in feed.slots if not s.dense]
    if sparse and max_sparse_len is None:
        raise ValueError(
            f"sparse slots {sparse} need max_sparse_len for the "
            "static-shape padded form")
    device = next(trainer.module.parameters()).device

    def batches():
        for b in feed:
            if drop_last and _batch_rows(b) != batch_size:
                continue
            out = {}
            for name, v in b.items():
                out[name] = (to_padded(v[0], v[1], max_sparse_len)
                             if isinstance(v, tuple) else v)
            yield batch_fn(out) if batch_fn is not None else out

    for _ in range(epochs):
        for batch in device_prefetch(batches(), size=prefetch,
                                     device=device):
            fetches = trainer.train_step(batch)
            if callback is not None:
                callback(trainer.step, fetches)
    return trainer.state()


class Executor:
    """Run programs with feed and fetch (executor.py:330, ≈ fluid.Executor):
    `run(program, feed, fetch_list)`, where a program is a callable over
    tensors that returns a dict.

    JAX jits a program once per input signature and caches the compiled
    executable. PyTorch runs a program eagerly, with no compile step, so
    an entry here holds the program itself: the cache keeps JAX's
    accounting (keyed on (program, signature), LRU-bounded by
    FLAGS_executor_cache_capacity, read at every run, with its hits,
    misses and evictions), which tells a caller how many distinct
    shapes a program sees. Feeds go to `place` (the card by default)."""

    def __init__(self, place: DeviceLike = None):
        self.place = resolve_device(place)
        self._cache: "OrderedDict[Tuple, Callable]" = OrderedDict()
        self.cache_misses = 0
        self.cache_hits = 0
        self.cache_evictions = 0
        _live_executors.add(self)

    @staticmethod
    def _signature(feed: Dict[str, torch.Tensor]) -> Tuple:
        return tuple((k, tuple(feed[k].shape), str(feed[k].dtype))
                     for k in sorted(feed))

    def run(self, program: Callable,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[str]] = None):
        """program(**feed) -> dict of outputs; returns [outputs[k] for k
        in fetch_list] (or the whole output without a fetch_list)."""
        args = {k: torch.as_tensor(v, device=self.place)
                for k, v in (feed or {}).items()}
        key = (program, self._signature(args))
        fn = self._cache.get(key)
        if fn is None:
            fn = self._cache[key] = program
            self.cache_misses += 1
        else:
            self._cache.move_to_end(key)
            self.cache_hits += 1
        # enforced on hits too: lowering the flag live shrinks the cache
        cap = FLAGS.get("executor_cache_capacity")
        while cap > 0 and len(self._cache) > cap:
            self._cache.popitem(last=False)
            self.cache_evictions += 1
        with RecordEvent("Executor.run"):
            out = fn(**args)
        if FLAGS.get("check_nan_inf"):
            check_nan_inf(out, "program outputs")
        if fetch_list is None:
            return out
        if not isinstance(out, dict):
            raise ExecutorError("fetch_list given but program returned "
                                f"{type(out).__name__}, expected dict")
        missing = [k for k in fetch_list if k not in out]
        if missing:
            raise ExecutorError(f"fetch targets not produced: {missing}")
        return [out[k] for k in fetch_list]

    def cache_stats(self) -> Dict[str, int]:
        return {"entries": len(self._cache), "hits": self.cache_hits,
                "misses": self.cache_misses,
                "evictions": self.cache_evictions}

    def close(self) -> None:
        self._cache.clear()


# live executors, for executor_cache_stats (weak: an Executor's lifetime
# is its owner's business)
_live_executors: "weakref.WeakSet[Executor]" = weakref.WeakSet()


def executor_cache_stats() -> List[Dict[str, int]]:
    """The cache stats of every live Executor (executor.py:410)."""
    return [e.cache_stats() for e in _live_executors]


class NaiveExecutor:
    """Inference-only runner of one function (executor.py:415): `run`
    calls `fn` under torch.inference_mode() on `place` (the card by
    default), where its arguments are put, as JAX keeps the compiled
    callable's buffers on the device. JAX compiles `fn` for its example
    arguments and its executable refuses others; so does this: an
    argument whose shape, dtype or device differs from its example's
    raises TypeError."""

    def __init__(self, fn: Callable, example_args: Sequence[Any],
                 place: DeviceLike = None):
        self.place = resolve_device(place)
        self._fn = fn
        self._spec = self._spec_of(
            [torch.as_tensor(a, device=self.place) for a in example_args])

    @staticmethod
    def _spec_of(args: Sequence[torch.Tensor]) -> List[Tuple]:
        return [(tuple(a.shape), a.dtype, a.device) for a in args]

    def run(self, *args):
        args = [torch.as_tensor(a, device=self.place) for a in args]
        got = self._spec_of(args)
        if got != self._spec:
            raise TypeError(f"arguments {got} differ from the examples "
                            f"{self._spec} this executor was built for")
        with torch.inference_mode():
            return self._fn(*args)
