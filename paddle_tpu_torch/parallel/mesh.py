"""Device mesh construction (port of paddle_tpu/parallel/mesh.py).

Axis conventions, as in the JAX package:
- "dp"  data parallel (batch sharded)
- "fsdp" param+optimizer sharded data parallel (ZeRO)
- "tp"  tensor parallel (features sharded)
- "sp"  sequence/context parallel (ring attention axis)
- "ep"  expert parallel (MoE)
- "pp"  pipeline parallel stage axis

The port's meshes span ONE device: the card, or the CPU when the caller
asks for it (`make_mesh(devices=["cpu"])`). A mesh over several devices
needs `torch.distributed` collectives (ROADMAP.md item 10) and raises
NotImplementedError until then.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

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
    size."""
    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The mesh's one device."""
        return self.devices.flat[0]


def _indexed(dev: torch.device) -> torch.device:
    """`cuda` -> `cuda:<current>`, the form a tensor's .device takes."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None, **axis_sizes) -> Mesh:
    """Build a Mesh from a MeshConfig or axis_sizes kwargs over
    `devices` (default: every CUDA device of the process; raises
    without a card). One axis may be -1 (inferred). Axes of size 1 are
    kept, so every axis name resolves."""
    if config is None:
        config = MeshConfig(**axis_sizes)
    if devices is None:
        resolve_device(None)          # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(resolve_device(d)) for d in devices]
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
    if total > 1:
        raise NotImplementedError(
            f"mesh {sizes} spans {total} devices; the port's meshes span "
            "one device until meshes over torch.distributed land "
            "(ROADMAP.md item 10)")
    if total != len(devices):
        raise ValueError(
            f"mesh {sizes} needs {total} devices, have {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(sizes[a] for a in AXIS_ORDER)), AXIS_ORDER)
