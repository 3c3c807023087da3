"""Per-block symmetric int8 codec for KV blocks (port of
paddle_tpu/quant/int8_compute.py:47, 278-332).

The engine's in-device compressed tier stores cold prefix blocks as
int8 with one f32 scale per block (engine/paged_cache.py). The codec
must be bit-equal to the JAX package's, so that a block compressed by
either package dequantizes to the same bytes, and so that the CUDA
mixed kernel's in-register dequant reproduces `dequantize_block`:

- quantize: scale = max(max|x|, KV_SCALE_FLOOR) over the block;
  q = clip(round(x / scale * QMAX), -QMAX, QMAX) in that order,
  rounding half to even (torch.round, as jnp.round).
- dequantize: (q -> f32) * (scale * RQMAX), then cast to the pool
  dtype. RQMAX is f32(1/127) rounded once: multiplying by it, never
  dividing by QMAX, keeps every dequant site (this function, the
  plain mixed gather, the CUDA kernel) on the same two roundings.

The host KV tier (engine/kvtier.py) uses the JAX package's host pair on
numpy, `quantize_host_int8` / `dequantize_host_int8`: one abs-max scale
per array, dequantized as q * (scale / QMAX).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

QMAX = 127.0
#: abs-max floor for device KV block scales: an all-zero block gets a
#: tiny positive scale, so 0 quantizes and dequantizes to exactly 0
KV_SCALE_FLOOR = 1e-30
#: f32 reciprocal of QMAX, rounded once (0x1.020408p-7)
RQMAX = float(np.float32(1.0) / np.float32(QMAX))


def quantize_block(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize over the trailing (block_size, heads, head_dim) axes: a
    3-D block gives a scalar scale, a 4-D [lanes, ...] batch one scale
    per lane. Returns (int8 tensor, f32 scales of shape x.shape[:-3])."""
    xf = x.float()
    scale = xf.abs().amax(dim=(-3, -2, -1)).clamp_min(KV_SCALE_FLOOR)
    q = torch.round(xf / scale[..., None, None, None] * QMAX)
    return q.clamp(-QMAX, QMAX).to(torch.int8), scale


def dequantize_block(q: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Inverse of quantize_block: max abs error is scale / QMAX per
    element. `scale` broadcasts over the trailing three axes."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    return (q.float() * (s * RQMAX)[..., None, None, None]).to(dtype)


def quantize_host_int8(x: np.ndarray) -> Tuple[np.ndarray, float]:
    """Per-tensor abs-max int8 quantization on the host (the host KV
    tier's codec). Its 1e-12 floor only engages below any real KV
    magnitude, so on real content its scale equals quantize_block's."""
    xf = np.asarray(x, dtype=np.float32)
    scale = float(max(np.max(np.abs(xf)), 1e-12))
    q = np.clip(np.round(xf / scale * QMAX), -QMAX, QMAX)
    return q.astype(np.int8), scale


def dequantize_host_int8(q: np.ndarray, scale: float, dtype) -> np.ndarray:
    """Inverse of quantize_host_int8, as the JAX package computes it:
    (q -> f32) * (scale / QMAX), then cast to the numpy `dtype`; max abs
    error is scale / QMAX per element (one quantization step)."""
    return (np.asarray(q, np.float32) * (scale / QMAX)).astype(dtype)
