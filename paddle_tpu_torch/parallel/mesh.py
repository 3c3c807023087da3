"""Device mesh construction (port of paddle_tpu/parallel/mesh.py).

Axis conventions, as in the JAX package:
- "dp"  data parallel (batch sharded)
- "fsdp" param+optimizer sharded data parallel (ZeRO)
- "tp"  tensor parallel (features sharded)
- "sp"  sequence/context parallel (ring attention axis)
- "ep"  expert parallel (MoE)
- "pp"  pipeline parallel stage axis

A mesh of one device is the card, or the CPU when the caller asks for
it (`make_mesh(devices=["cpu"])`). A mesh over several ranks is SPMD
over `torch.distributed`: each process is one rank, and rank r sits at
`np.unravel_index(r, shape)` in AXIS_ORDER, where JAX's make_mesh puts
`jax.devices()[r]`, so port rank r holds the slices JAX's device r
holds. Rank r takes `devices[r]`.

`make_mesh` builds one c10d group for each line of every multi-rank
axis (the ranks that differ only in that axis's coordinate) and one for
each combination of multi-rank axes (the batch axes a gradient is
averaged over, the whole world for the bad-step guard); `Mesh.group`
names them by an axis or a tuple of axes. The data plane's backend is
chosen, never switched on failure: nccl when every rank has a card of
its own, gloo when ranks share a card or run on the CPU (NCCL refuses
two ranks on one device, so the caller says gloo there).

`with mesh:` makes the mesh current (`current_mesh()`), as
`MeshTrainer.train_step` does: the layers that run collectives inside
the forward (Megatron tp, sync-BN, ShardedEmbedding) resolve their axis
groups from it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from paddle_tpu_torch.device import indexed, resolve_device
from paddle_tpu_torch.parallel.collective import AxisGroup, world_group

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")

AxisKey = Union[str, Tuple[str, ...]]


@dataclasses.dataclass
class MeshConfig:
    """Named mesh-shape spec; -1 on one axis means 'all remaining
    devices'."""
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}


_current = threading.local()


def current_mesh() -> Optional["Mesh"]:
    """The innermost mesh entered by this thread (`with mesh:`), or
    None."""
    stack = getattr(_current, "stack", None)
    return stack[-1] if stack else None


def current_batch_axes() -> Optional[Tuple[str, ...]]:
    """The batch axes of the innermost `batch_axes_scope` (a trainer's
    step), or None."""
    stack = getattr(_current, "batch_axes", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def batch_axes_scope(axes: Sequence[str]):
    """Name the axes the data of the step is sharded over while open (a
    layer whose collectives depend on it reads `current_batch_axes`)."""
    if not hasattr(_current, "batch_axes"):
        _current.batch_axes = []
    _current.batch_axes.append(tuple(axes))
    try:
        yield
    finally:
        _current.batch_axes.pop()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A device mesh: `devices` shaped by the axes of `axis_names` (the
    counterpart of `jax.sharding.Mesh`); `shape` maps each axis to its
    size. A mesh over several ranks also holds this process's `rank`,
    the data plane's `backend` and the process groups of its
    multi-rank axes (`groups`, keyed by an axis name or a tuple of them
    in AXIS_ORDER)."""
    devices: np.ndarray
    axis_names: tuple
    groups: Dict[AxisKey, AxisGroup] = dataclasses.field(default_factory=dict)
    rank: int = 0
    backend: Optional[str] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """This rank's device (the mesh's one device on one rank)."""
        return self.devices.flat[self.rank]

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis."""
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            self.rank, self.devices.shape))))

    def wide(self, axes: Sequence[str] = AXIS_ORDER) -> Tuple[str, ...]:
        """The axes of `axes` that span more than one rank, in
        AXIS_ORDER."""
        shape = self.shape
        return tuple(a for a in self.axis_names
                     if a in axes and shape[a] > 1)

    def group(self, axis: AxisKey) -> AxisGroup:
        """The process group over `axis` (a name, or a tuple whose
        multi-rank axes the group spans)."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        key = self.wide(names)
        if not key:
            raise KeyError(f"axis {axis!r} spans no ranks in mesh "
                           f"{self.shape}")
        key = key[0] if len(key) == 1 else key
        if key not in self.groups:
            raise KeyError(f"no process group for {key!r} in mesh "
                           f"{self.shape}")
        return self.groups[key]

    def maybe_group(self, axis: AxisKey) -> Optional[AxisGroup]:
        """`group(axis)`, or None when `axis` spans no ranks."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        return self.group(names) if self.wide(names) else None

    def __enter__(self) -> "Mesh":
        if not hasattr(_current, "stack"):
            _current.stack = []
        _current.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _current.stack.pop()


def _resolve_sizes(config: MeshConfig, n: int) -> Dict[str, int]:
    sizes = config.sizes()
    unknown = [a for a, s in sizes.items() if s == -1]
    if len(unknown) > 1:
        raise ValueError(f"only one axis may be -1, got {unknown}")
    known = math.prod(s for s in sizes.values() if s != -1)
    if unknown:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    return sizes


def rank_devices(n: int) -> list:
    """Every rank's device when the caller names none: PTPU_DEVICES
    (comma-separated, in rank order, as parallel/launch.py sets it), else
    rank r on card r (raises without a card)."""
    env = os.environ.get("PTPU_DEVICES")
    if env:
        return env.split(",")[:n]
    resolve_device(None)
    return [f"cuda:{r}" for r in range(n)]


def choose_backend(devices: Sequence[torch.device],
                   backend: Optional[str] = None) -> str:
    """The data plane's backend: `backend` (or PTPU_BACKEND) when given;
    else gloo for ranks on the CPU and nccl for ranks each on a card of
    its own. Ranks that share a card must ask for gloo."""
    backend = backend or os.environ.get("PTPU_BACKEND") or None
    if backend is not None:
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"unknown backend {backend!r}: 'gloo' or "
                             "'nccl'")
        if backend == "nccl" and any(d.type != "cuda" for d in devices):
            raise ValueError("backend 'nccl' needs every rank on a card")
        return backend
    if all(d.type == "cpu" for d in devices):
        return "gloo"
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"ranks on {sorted({str(d) for d in devices})}: "
                         "name the backend")
    if len(set(devices)) < len(devices):
        raise ValueError(
            "ranks share a card, where NCCL refuses them: pass "
            "backend='gloo' (the data plane then stages through host "
            "memory)")
    return "nccl"


def _axis_groups(sizes: Dict[str, int], rank: int, backend: str,
                 device: torch.device) -> Dict[AxisKey, AxisGroup]:
    """One c10d group for each line of every multi-rank axis and each
    combination of them, made by every rank in the same order (c10d's
    contract); this rank keeps the ones it belongs to."""
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(device)
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    wide = [i for i, a in enumerate(AXIS_ORDER) if sizes[a] > 1]
    ranks = np.arange(math.prod(shape)).reshape(shape)
    groups: Dict[AxisKey, AxisGroup] = {}
    for k in range(1, len(wide) + 1):
        for combo in itertools.combinations(wide, k):
            key = tuple(AXIS_ORDER[i] for i in combo)
            # the ranks that differ only in the combo's coordinates
            lines = np.moveaxis(ranks, combo, list(range(-k, 0))).reshape(
                -1, math.prod(shape[i] for i in combo))
            for line in lines:
                pg = dist.new_group([int(r) for r in line], backend=backend)
                if rank in line:
                    groups[key[0] if k == 1 else key] = AxisGroup(pg,
                                                                  backend)
    return groups


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None,
              group: Optional[AxisGroup] = None,
              backend: Optional[str] = None, **axis_sizes) -> Mesh:
    """Build a Mesh from a MeshConfig or axis_sizes kwargs, one device a
    rank. One axis may be -1 (inferred); axes of size 1 are kept, so
    every axis name resolves.

    One rank: `devices` defaults to PTPU_DEVICES when set, else every
    CUDA device of the process (raises without a card). Several ranks:
    every process of the
    `init_distributed` world calls make_mesh with the same arguments;
    `devices` lists every rank's device in rank order (default
    `rank_devices`), `backend` is the data plane's ('gloo' or 'nccl';
    default `choose_backend`). A `group` (a private group, as the
    tensor-parallel engine makes) carries a mesh whose only multi-rank
    axis is tp."""
    if config is None:
        config = MeshConfig(**axis_sizes)
    sizes = _resolve_sizes(config, len(devices) if devices is not None
                           else (group.size if group is not None else
                                 _world_size()))
    total = math.prod(sizes.values())
    if devices is None:
        if total > 1 or os.environ.get("PTPU_DEVICES"):
            devices = rank_devices(total)
        else:
            resolve_device(None)          # raises without a card
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = [indexed(resolve_device(d)) for d in devices]
    if total != len(devices):
        raise ValueError(
            f"mesh {sizes} needs {total} devices, have {len(devices)}")
    groups: Dict[AxisKey, AxisGroup] = {}
    rank, chosen = 0, None
    if total > 1:
        if group is not None:
            wide = sorted(a for a, s in sizes.items() if s > 1)
            if wide != ["tp"]:
                raise ValueError(f"mesh {sizes}: a private group carries "
                                 "only a tp axis")
            if group.size != total:
                raise ValueError(f"tp axis of {total} ranks over a process "
                                 f"group of {group.size}")
            groups["tp"], rank, chosen = group, group.rank, group.backend
        else:
            world = world_group()
            if world.size != total:
                raise ValueError(f"mesh {sizes} needs {total} ranks, the "
                                 f"world has {world.size}")
            rank = world.rank
            chosen = choose_backend(devices, backend)
            groups = _axis_groups(sizes, rank, chosen, devices[rank])
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(sizes[a] for a in AXIS_ORDER)), AXIS_ORDER,
                groups, rank, chosen)


def _world_size() -> int:
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    if torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def local_mesh(n: Optional[int] = None, axis: str = "dp") -> Mesh:
    """A one-axis mesh over n ranks (default: the whole world, or the
    process's cards on one rank): the common data-parallel case."""
    return make_mesh(MeshConfig(**{axis: n or _world_size()}))


__all__ = ["AXIS_ORDER", "Mesh", "MeshConfig", "batch_axes_scope",
           "choose_backend", "current_batch_axes", "current_mesh",
           "local_mesh", "make_mesh", "rank_devices"]
