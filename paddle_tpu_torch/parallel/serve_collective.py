"""Serving collectives: the decode-step allreduce, quantized (port of
paddle_tpu/parallel/serve_collective.py).

Tensor-parallel serving splits each block's MLP column-then-row, which
leaves one allreduce a block on the fc2 row-parallel product (and one
fp sum on out_proj's). At decode batch sizes that allreduce is bound by
latency and wire bytes, so it can ship int8 instead (EQuARX, PAPERS.md):
each rank quantizes its partial product to int8 in chunks with one f32
abs-max scale a chunk, the ranks all-gather the int8 values and the
scales, and every rank sums the dequantized shards in f32, in rank
order. `PTPU_SERVE_ALLREDUCE=fp` is the exact sum.

The arithmetic follows JAX's order of operations step for step (the
scale floor, `x * (127 / scale)` with the quotient taken first, round
half to even, `q * (s * (1/127))` with 1/127 rounded to f32 once), so
the same shard inputs give JAX's numbers. The mode is resolved once,
when the engine is built (`resolve_mode`).
"""

from __future__ import annotations

import os
import time
from typing import Tuple

import torch

from paddle_tpu_torch.parallel.collective import (AxisGroup, all_gather,
                                                  all_reduce)
from paddle_tpu_torch.quant.int8_compute import RQMAX

#: blockwise-quantization granularity: one f32 scale per CHUNK scalars
DEFAULT_CHUNK = 256

_MODES = ("int8", "fp")


def resolve_mode(env=None) -> str:
    """PTPU_SERVE_ALLREDUCE, read once when an engine is built: "int8"
    (default) is the quantized collective, "fp" the exact sum the parity
    gates run under."""
    mode = (env if env is not None
            else os.environ.get("PTPU_SERVE_ALLREDUCE", "int8")).lower()
    if mode not in _MODES:
        raise ValueError(
            f"PTPU_SERVE_ALLREDUCE={mode!r} not in {_MODES}: 'int8' is the "
            "quantized collective, 'fp' the exact-identity fallback")
    return mode


class ServeTP:
    """A rank's tensor-parallel serving context: the data-plane group,
    this process's rank in it, the tp degree, the collective's wire
    format and its chunk. Holds no tensors."""

    __slots__ = ("group", "rank", "size", "mode", "chunk")

    def __init__(self, group: AxisGroup, size: int, mode: str = "int8",
                 chunk: int = DEFAULT_CHUNK):
        if mode not in _MODES:
            raise ValueError(f"mode {mode!r} not in {_MODES}")
        if group.size != int(size):
            raise ValueError(f"tp size {size} over a group of {group.size}")
        self.group = group
        self.rank = group.rank
        self.size = int(size)
        self.mode = mode
        self.chunk = int(chunk)

    def __repr__(self) -> str:  # shows up in debug_state()
        return f"ServeTP(size={self.size}, mode={self.mode!r})"


def quantized_all_reduce(x: torch.Tensor, group: AxisGroup,
                         chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """EQuARX-style blockwise-int8 allreduce over `group`: flatten, pad
    to a chunk multiple, one f32 abs-max scale a chunk (floored at 1e-30,
    so an all-zero chunk stays exactly 0), symmetric round-to-nearest
    clamped at +-127; all-gather the int8 payload and the scales, and
    sum the dequantized shards in f32 in rank order. Returns x's shape
    and dtype."""
    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    pad = (-n) % chunk
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    ch = flat.reshape(-1, chunk)                          # [nc, chunk]
    scale = ch.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    q = torch.round(ch * (torch.full_like(scale, 127.0) / scale))
    q = q.clamp(-127.0, 127.0).to(torch.int8)
    qg = all_gather(q, group, tiled=False)                # [tp, nc, chunk]
    sg = all_gather(scale, group, tiled=False)            # [tp, nc, 1]
    terms = qg.float() * (sg * torch.tensor(RQMAX, device=sg.device))
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc.reshape(-1)[:n].reshape(orig_shape).to(orig_dtype)


def serve_all_reduce(x: torch.Tensor, group: AxisGroup, mode: str,
                     chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """The row-parallel reduction: "fp" is the exact sum, "int8" trades
    a bounded quantization error for about 1/8 of the wire bytes."""
    if mode == "fp":
        return all_reduce(x, group)
    return quantized_all_reduce(x, group, chunk=chunk)


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor,
                        tp: ServeTP) -> torch.Tensor:
    """y = x @ w with the contraction dim sharded over the ranks: x
    [..., K/tp] (this rank's columns of the column-parallel fc1's
    output), w [K/tp, N] (this rank's rows); each rank's partial product
    is combined by `serve_all_reduce`. A bias goes on AFTER this call:
    inside, it would be summed tp times."""
    lead = x.shape[:-1]
    part = torch.matmul(x.reshape(-1, x.shape[-1]), w)
    y = serve_all_reduce(part, tp.group, tp.mode, tp.chunk)
    return y.reshape(*lead, w.shape[-1])


def allreduce_probe_ms(group: AxisGroup, mode: str,
                       shape: Tuple[int, ...] = (64, 512),
                       dtype: torch.dtype = torch.float32,
                       chunk: int = DEFAULT_CHUNK,
                       device=None) -> float:
    """One-shot wall-clock probe of the serving allreduce over `group`:
    every rank calls it; the first call is a warm-up, the second is
    timed (the engine records it in ptpu_serve_allreduce_ms{mode})."""
    x = torch.ones(shape, dtype=dtype, device=device)
    serve_all_reduce(x, group, mode, chunk)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    serve_all_reduce(x, group, mode, chunk)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return (time.perf_counter() - t0) * 1e3


def allreduce_wire_bytes(model_dim: int, mode: str,
                         tp_size: int, chunk: int = DEFAULT_CHUNK,
                         dtype_bytes: int = 4) -> int:
    """Analytic wire bytes per token per block of the decode MLP
    reduction: a ring fp allreduce moves 2*(tp-1)/tp * dtype_bytes*D;
    the int8 all-gather moves (tp-1)*(D + 4*D/chunk), payload plus
    scales."""
    if tp_size <= 1:
        return 0
    if mode == "fp":
        return int(2 * (tp_size - 1) / tp_size * dtype_bytes * model_dim)
    return int((tp_size - 1) * (model_dim + 4 * model_dim / chunk))
