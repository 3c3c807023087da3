"""Seeded `torch.Generator`s for the port's random streams.

JAX derives a stream's key by folding data (a step, a position) into a
seed's key; the port seeds a fresh generator from (seed, data) instead.
The bits differ from JAX's; the reproducibility is the same: the same
seed and data give the same draws.
"""

from __future__ import annotations

import torch


def fold_in(seed: int, data: int, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, data). The CPU
    generator seeds from the low 32 bits only, so both parts must reach
    them (1000003 is odd, so distinct seeds stay apart)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & 0xFFFFFFFF) * 1000003 + data)
                    & 0xFFFFFFFFFFFFFFFF)
    return gen
