"""Device resolution for the port's entry points.

`CausalLM(...)`, `PagedKVCache(...)` and `ServeEngine(...)` default to
the CUDA card. Without a card they raise instead of dropping to the CPU
on their own: a CPU run is always asked for explicitly
(`device="cpu"`), so a number taken on the CPU can never pass for a
number taken on the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> the CUDA card. A CUDA device with no card present
    raises RuntimeError naming `device="cpu"` as the way to run on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on "
            "the CPU")
    return dev
