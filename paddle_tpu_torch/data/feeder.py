"""Host -> device feeding with prefetch (port of paddle_tpu/data/feeder.py).

`device_prefetch` and `DataFeeder` put numpy batches on the card (the
default) through pinned host memory with non-blocking copies, so the
copy of batch k+1 overlaps batch k's step (Paddle's BufferedReader does
this on a dedicated CUDA stream; JAX's `device_put` is asynchronous).
The CPU is used only when the caller asks for it (`device="cpu"`).
JAX's `sharding=` (a mesh placement) comes with the meshes of ROADMAP
item 10 and raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, indexed, resolve_device
from paddle_tpu_torch.utils.tree import map_leaves


def _no_sharding(sharding) -> None:
    if sharding is not None:
        raise NotImplementedError(
            "sharding= (a mesh placement) comes with the meshes of "
            "ROADMAP item 10; pass device= for one device")


def to_device(x, device: torch.device) -> torch.Tensor:
    """One numpy leaf on `device`: on CUDA through a pinned host copy and
    a non-blocking copy on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_prefetch(it: Iterable, size: int = 2,
                    device: DeviceLike = None,
                    sharding: Optional[Any] = None) -> Iterator:
    """Yield batches (numpy trees: arrays, tuples, lists, dicts) as tensors
    on `device` (default the card), keeping `size` copies in flight."""
    _no_sharding(sharding)
    device = indexed(resolve_device(device))

    def put(batch):
        return map_leaves(lambda x: to_device(x, device), batch)
    queue = []
    it = iter(it)
    try:
        for _ in range(size):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    for batch in it:
        out = queue.pop(0)
        queue.append(put(batch))
        yield out
    while queue:
        yield queue.pop(0)


class DataFeeder:
    """Convert samples / batches to tensors on `device` (default the card)
    with dtype conventions (fluid.DataFeeder's role): `feed(batch)` takes
    a name-keyed dict or a sequence in `feed_names` order and returns
    {name: tensor}, each cast first to its `dtypes` entry when given.
    Ragged sequence feeds use dense padding plus explicit lengths."""

    def __init__(self, feed_names: Sequence[str], dtypes=None,
                 device: DeviceLike = None,
                 sharding: Optional[Any] = None):
        _no_sharding(sharding)
        self.feed_names = list(feed_names)
        self.dtypes = dtypes or {}
        self.device = indexed(resolve_device(device))

    def feed(self, batch) -> dict:
        if isinstance(batch, dict):
            items = [(k, batch[k]) for k in self.feed_names]
        else:
            items = list(zip(self.feed_names, batch))
        out = {}
        for name, value in items:
            arr = np.asarray(value)
            if name in self.dtypes:
                arr = arr.astype(self.dtypes[name])
            out[name] = to_device(arr, self.device)
        return out
