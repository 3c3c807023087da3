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
over `torch.distributed`: each process is one rank, holds the device
`devices[rank]`, and reaches its peers through the process group of
the axis (`Mesh.group`, parallel/collective.py). Only a `tp` axis may
span ranks so far (tensor-parallel serving); the other multi-rank axes
are distributed training (ROADMAP.md item 10) and raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.device import indexed, resolve_device
from paddle_tpu_torch.parallel.collective import AxisGroup, world_group

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


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


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A device mesh: `devices` shaped by the axes of `axis_names` (the
    counterpart of `jax.sharding.Mesh`); `shape` maps each axis to its
    size. A mesh over several ranks also holds the process group of
    its multi-rank axis (`groups`) and this process's `rank`."""
    devices: np.ndarray
    axis_names: tuple
    groups: Dict[str, AxisGroup] = dataclasses.field(default_factory=dict)
    rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """This rank's device (the mesh's one device on one rank)."""
        return self.devices.flat[self.rank]

    def group(self, axis: str) -> AxisGroup:
        """The process group of a multi-rank axis."""
        if axis not in self.groups:
            raise KeyError(f"axis {axis!r} spans no ranks in mesh "
                           f"{self.shape}")
        return self.groups[axis]


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None,
              group: Optional[AxisGroup] = None, **axis_sizes) -> Mesh:
    """Build a Mesh from a MeshConfig or axis_sizes kwargs over
    `devices` (default: every CUDA device of the process; raises
    without a card), one device a rank. One axis may be -1 (inferred).
    Axes of size 1 are kept, so every axis name resolves. A `tp` axis
    over several ranks runs over `group` (default: the process's group
    from `init_distributed`), whose size must be the axis's."""
    if config is None:
        config = MeshConfig(**axis_sizes)
    if devices is None:
        resolve_device(None)          # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [indexed(resolve_device(d)) for d in devices]
    sizes = config.sizes()
    unknown = [a for a, s in sizes.items() if s == -1]
    if len(unknown) > 1:
        raise ValueError(f"only one axis may be -1, got {unknown}")
    known = math.prod(s for s in sizes.values() if s != -1)
    if unknown:
        if len(devices) % known:
            raise ValueError(
                f"{len(devices)} devices not divisible by {known}")
        sizes[unknown[0]] = len(devices) // known
    total = math.prod(sizes.values())
    wide = sorted(a for a, s in sizes.items() if s > 1 and a != "tp")
    if wide:
        raise NotImplementedError(
            f"mesh {sizes}: axes {wide} over several ranks are "
            "distributed training, not ported yet (ROADMAP.md item 10); "
            "only a tp axis spans ranks")
    if total != len(devices):
        raise ValueError(
            f"mesh {sizes} needs {total} devices, have {len(devices)}")
    groups: Dict[str, AxisGroup] = {}
    rank = 0
    if total > 1:
        group = group if group is not None else world_group()
        if group.size != total:
            raise ValueError(f"tp axis of {total} ranks over a process "
                             f"group of {group.size}")
        groups["tp"], rank = group, group.rank
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(sizes[a] for a in AXIS_ORDER)), AXIS_ORDER,
                groups, rank)
