"""Zero-copy tensor interop over DLPack (port of
paddle_tpu/utils/interop.py; Fluid's framework/dlpack_tensor.{h,cc}).

The JAX package's own array type is `jax.Array`, so its helpers turn
other frameworks' arrays (torch tensors among them) into jax arrays and
back. The port's own array type IS `torch.Tensor`, so here:

- `to_dlpack(t)` gives a DLPack capsule of a tensor;
- `from_dlpack(obj)` takes any `__dlpack__` producer (a numpy array, a
  jax array, a tensor of another library) and gives a tensor on the
  producer's device, sharing its memory (zero-copy);
- `to_torch` is `from_dlpack`: anything -> the port's array type;
- `from_torch` and `tree_from_torch` convert torch tensors into the
  port's array type, which they already are: they return the tensors
  (and the tree) as they are, the same objects.

To hand a port tensor to JAX, give JAX the tensor itself
(`jax.dlpack.from_dlpack(t)`), as JAX's `from_dlpack` asks.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils.dlpack as tdl

Pytree = Any


def to_dlpack(t: torch.Tensor):
    """torch.Tensor -> DLPack capsule (consumed once, by any DLPack
    consumer that accepts capsules, e.g. `torch.utils.dlpack.from_dlpack`).
    Consumers that take only protocol objects (JAX's `from_dlpack`)
    should be handed the tensor itself."""
    return tdl.to_dlpack(t)


def from_dlpack(obj) -> torch.Tensor:
    """Any `__dlpack__`-bearing object (numpy / jax array, tensor) or a
    DLPack capsule -> torch.Tensor on the producer's device, zero-copy."""
    return tdl.from_dlpack(obj)


def to_torch(x) -> torch.Tensor:
    """Another framework's array -> torch.Tensor via DLPack (the JAX
    package's `to_torch`; here the same as `from_dlpack`)."""
    return from_dlpack(x)


def from_torch(t: torch.Tensor) -> torch.Tensor:
    """torch.Tensor -> the port's array type: the tensor itself."""
    return t


def tree_from_torch(tree: Pytree) -> Pytree:
    """Every torch.Tensor leaf of a tree (a state_dict, a DataLoader
    batch) as the port's array type: the tree itself, unchanged."""
    return tree
