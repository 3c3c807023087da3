"""Host -> device feeding with prefetch (port of paddle_tpu/data/feeder.py).

`device_prefetch` and `DataFeeder` put numpy batches on the card (the
default) through pinned host memory with non-blocking copies, so the
copy of batch k+1 overlaps batch k's step (Paddle's BufferedReader does
this on a dedicated CUDA stream; JAX's `device_put` is asynchronous).
The CPU is used only when the caller asks for it (`device="cpu"`).
`sharding=` takes a mesh's batch placement (`MeshTrainer.batch_sharding()`,
a parallel.sharding.BatchSharding): each leaf's rows of this rank go to
the rank's device, as JAX's `sharding=` puts each device's rows.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, indexed, resolve_device
from paddle_tpu_torch.utils.tree import map_leaves


def _placement(sharding, device: DeviceLike):
    """(rows of a leaf for this rank, its device) of `sharding` or of
    `device` (default the card)."""
    if sharding is None:
        return (lambda x: x), indexed(resolve_device(device))
    from paddle_tpu_torch.parallel.sharding import BatchSharding
    if not isinstance(sharding, BatchSharding):
        raise TypeError(f"sharding= takes a BatchSharding "
                        f"(MeshTrainer.batch_sharding()), got "
                        f"{type(sharding).__name__}")
    return sharding.local, indexed(resolve_device(sharding.device))


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
    on `device` (default the card), or this rank's rows of them on its
    device under `sharding`, keeping `size` copies in flight."""
    rows, device = _placement(sharding, device)

    def put(batch):
        return map_leaves(lambda x: to_device(rows(x), device), batch)
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
    {name: tensor}, each cast first to its `dtypes` entry when given
    (under `sharding`, this rank's rows on its device). Ragged sequence
    feeds use dense padding plus explicit lengths."""

    def __init__(self, feed_names: Sequence[str], dtypes=None,
                 device: DeviceLike = None,
                 sharding: Optional[Any] = None):
        self.feed_names = list(feed_names)
        self.dtypes = dtypes or {}
        self._rows, self.device = _placement(sharding, device)

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
            out[name] = to_device(self._rows(arr), self.device)
        return out
