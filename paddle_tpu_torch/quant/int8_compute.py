"""True int8 inference, and the per-block int8 codec of the KV tiers
(port of paddle_tpu/quant/int8_compute.py).

**int8 compute.** `freeze_int8` rewrites a float model's `Linear` and
`Conv2D` layers (by exact type, as `quant.layers` does) into
`Int8Linear` / `Int8Conv2D`, whose products run int8 x int8 -> int32
(`fake_quant.int8_mm`, `torch._int_mm`):

- weights: int8 `weight` (a parameter that takes no gradient, JAX's
  `params` entry of that name) with a per-output-channel f32 `w_scale`,
  w8 = clip(round(w / ws * QMAX)), ws = max(abs-max, 1e-12);
- activations, three modes (`_act_quant`): while calibrating, the
  dynamic abs-max, whose EMA (momentum 0.9, the first batch taken as
  it is) moves the persistent buffer `act_scale` (JAX's `state`);
  after calibration (`static_act`), the frozen `act_scale` floored at
  1e-12; without calibration, the dynamic abs-max;
- y = y32 * (xs * ws / QMAX^2) in f32, then the bias in f32, then the
  cast to the layer's dtype, JAX's grouping (`int8_matmul` groups its
  rescale differently).

`Int8Conv2D` is an im2col of the already-padded int8 input (the port's
`Conv2D` padding rules: lax's SAME with its odd remainder, explicit
pairs, stride and dilation; zero pads quantize to exactly 0), then one
int8 GEMM per group. On CUDA `int8_mm` hands cuBLASLt its "TN" layout
and zero pads the shapes `torch._int_mm` refuses (M <= 16; K or N not a
multiple of 8, such as ResNet-50's stem, K = 7 * 7 * 3 = 147); the
int32 sums stay exact.

**The KV codec.** The engine's in-device compressed tier stores cold
prefix blocks as int8 with one f32 scale per block
(engine/paged_cache.py). The codec must be bit-equal to the JAX
package's, so that a block compressed by either package dequantizes to
the same bytes, and so that the CUDA mixed kernel's in-register dequant
reproduces `dequantize_block`:

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

from typing import Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

QMAX = 127.0
#: abs-max floor for device KV block scales: an all-zero block gets a
#: tiny positive scale, so 0 quantizes and dequantizes to exactly 0
KV_SCALE_FLOOR = 1e-30
#: f32 reciprocal of QMAX, rounded once (0x1.020408p-7)
RQMAX = float(np.float32(1.0) / np.float32(QMAX))


def block_scale(x: torch.Tensor) -> torch.Tensor:
    """quantize_block's scale: the abs-max over the trailing (block_size,
    heads, head_dim) axes, floored at KV_SCALE_FLOOR. Under tensor
    parallelism a rank holds some of the heads, and the block's scale is
    the MAX of the ranks' scales (a max of floored values is the floored
    max)."""
    return x.float().abs().amax(dim=(-3, -2, -1)).clamp_min(KV_SCALE_FLOOR)


def quantize_block(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize over the trailing (block_size, heads, head_dim) axes: a
    3-D block gives a scalar scale, a 4-D [lanes, ...] batch one scale
    per lane. `scale` (default `block_scale(x)`) gives the scales to
    quantize with. Returns (int8 tensor, f32 scales of shape
    x.shape[:-3])."""
    xf = x.float()
    if scale is None:
        scale = block_scale(x)
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


# -- int8 compute ------------------------------------------------------------
# Imported below the codec: the kernels import the codec above while
# `paddle_tpu_torch.nn` (which these layers need) is still loading.

from paddle_tpu_torch.nn.layers import (  # noqa: E402
    Conv2D, Linear, _pad_nhwc, _spatial_pads)
from paddle_tpu_torch.quant.fake_quant import int8_mm  # noqa: E402

#: calibration act-scale momentum (as quant/layers' EMA)
_EMA = 0.9


def _quant_with(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xq = torch.round(x.float() / scale * QMAX).clamp(-QMAX, QMAX)
    return xq.to(torch.int8)


def _act_quant(layer, x: torch.Tensor):
    """(int8 activations, their f32 scale) in the layer's mode: the
    calibration pass (dynamic abs-max, its EMA written to `act_scale`),
    static (the frozen `act_scale`, floored at 1e-12) or dynamic."""
    xf = x.float()
    if layer.calibrating:
        cur = xf.abs().amax().clamp_min(1e-12)
        prev = layer.act_scale
        with torch.no_grad():
            prev.copy_(torch.where(prev > 0,
                                   _EMA * prev + (1 - _EMA) * cur, cur))
        return _quant_with(xf, cur), cur
    if layer.static_act:
        scale = layer.act_scale.clamp_min(1e-12)
        return _quant_with(xf, scale), scale
    scale = xf.abs().amax().clamp_min(1e-12)
    return _quant_with(xf, scale), scale


def _channel_quant(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (last dim) int8 weights and their f32 scales."""
    w = w.detach().float()
    ws = w.abs().amax(dim=tuple(range(w.dim() - 1))).clamp_min(1e-12)
    w8 = torch.round(w / ws * QMAX).clamp(-QMAX, QMAX)
    return w8.to(torch.int8), ws


class _Int8Mixin:
    """The frozen weights and the activation modes of an int8 layer."""

    static_act = False
    calibrating = False

    @classmethod
    def from_float(cls, layer):
        """The int8 twin of a float layer: its weight quantized per
        output channel into `weight` (int8) and `w_scale` (f32), its
        bias and settings kept."""
        from paddle_tpu_torch.quant.layers import adopt
        q = adopt(cls, layer)
        w8, ws = _channel_quant(layer.weight)
        q.weight = nn.Parameter(w8, requires_grad=False)
        q.w_scale = nn.Parameter(ws, requires_grad=False)
        q.register_buffer("act_scale", None)
        return q

    def _rescale(self, y32: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        y = y32.float() * (xs * self.w_scale / (QMAX * QMAX))
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype)


class Int8Linear(_Int8Mixin, Linear):
    """Linear executing int8 x int8 -> int32. `weight` int8 [in, out],
    `w_scale` f32 [out], `bias` f32; the buffer `act_scale` once
    calibrated."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, xs = _act_quant(self, x)
        y32 = int8_mm(xq.reshape(-1, xq.shape[-1]), self.weight)
        return self._rescale(y32.reshape(*xq.shape[:-1], y32.shape[-1]), xs)


def im2col(xp: torch.Tensor, kernel, stride, dilation) -> torch.Tensor:
    """[N, Hp, Wp, C] (already padded) -> [N, Ho, Wo, kh * kw, C]: the
    window of every output position, taps in (kh, kw) order."""
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    ho = (xp.shape[1] - (kh - 1) * dh - 1) // sh + 1
    wo = (xp.shape[2] - (kw - 1) * dw - 1) // sw + 1
    taps = [xp[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
               j * dw:j * dw + (wo - 1) * sw + 1:sw]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=3)


def int8_conv2d(xq: torch.Tensor, w8: torch.Tensor, stride, padding,
                dilation, groups: int) -> torch.Tensor:
    """lax.conv_general_dilated over int8 NHWC input and an int8 HWIO
    kernel with int32 accumulation: an im2col of the padded input, then
    one `int8_mm` per group. Returns int32 [N, Ho, Wo, out]."""
    kh, kw, cg, cout = w8.shape
    pads = _spatial_pads(padding, xq.shape[1:3], (kh, kw), stride, dilation)
    cols = im2col(_pad_nhwc(xq, pads), (kh, kw), stride, dilation)
    n, ho, wo = cols.shape[:3]
    cols = cols.reshape(n * ho * wo, kh * kw, groups, cg)
    og = cout // groups
    outs = [int8_mm(cols[:, :, g].reshape(-1, kh * kw * cg),
                    w8[..., g * og:(g + 1) * og].reshape(kh * kw * cg, og))
            for g in range(groups)]
    y = outs[0] if groups == 1 else torch.cat(outs, dim=-1)
    return y.reshape(n, ho, wo, cout)


class Int8Conv2D(_Int8Mixin, Conv2D):
    """Conv2D executing int8 x int8 -> int32 (`int8_conv2d`). `weight`
    int8 [kh, kw, in/groups, out], `w_scale` f32 [out], `bias`; the
    buffer `act_scale` once calibrated."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, xs = _act_quant(self, x)
        y32 = int8_conv2d(xq, self.weight, self.stride, self.padding,
                          self.dilation, self.groups)
        return self._rescale(y32, xs)


INT8_LAYERS = (Int8Linear, Int8Conv2D)


def _rewrite(m: nn.Module) -> nn.Module:
    if type(m) is Linear:
        return Int8Linear.from_float(m)
    if type(m) is Conv2D:
        return Int8Conv2D.from_float(m)
    int8_compute_model(m)
    return m


def int8_compute_model(module: nn.Module) -> nn.Module:
    """In-place rewrite: every plain Linear / Conv2D child becomes its
    Int8* twin, its weight frozen to int8; other modules are recursed
    into (`quant.layers.swap_layers`)."""
    from paddle_tpu_torch.quant.layers import swap_layers
    return swap_layers(module, _rewrite)


def _set_flag(module: nn.Module, attr: str, flag: bool) -> None:
    for m in module.modules():
        if isinstance(m, INT8_LAYERS):
            setattr(m, attr, flag)


def run_batches(module: nn.Module, batches: Iterable,
                training: bool) -> int:
    """The forward over every batch (a tuple or list is the arguments,
    anything else the one argument) without gradients, in training or
    eval mode (restored after). In training mode the forward gets a
    generator seeded 0, as JAX's `calibrate` passes key(0); in eval mode
    it draws nothing and gets none, as in JAX's `freeze_int8`, so a bare
    int8 layer runs too. Returns the count of batches."""
    device = next(module.parameters()).device
    kw = ({"generator": torch.Generator(device=device).manual_seed(0)}
          if training else {})
    was_training = module.training
    module.train(training)
    n = 0
    try:
        with torch.no_grad():
            for batch in batches:
                args = (tuple(batch) if isinstance(batch, (tuple, list))
                        else (batch,))
                module(*args, **kw)
                n += 1
    finally:
        module.train(was_training)
    return n


def freeze_int8(module: nn.Module, variables=None,
                calib_batches: Optional[Iterable] = None):
    """Freeze a float model to the int8 execution path. `variables` (a
    JAX-layout tree, as `to_jax_params` gives) is loaded first when
    given; otherwise the model's own weights are frozen. Rewrites the
    module tree in place (a bare Linear / Conv2D root is converted and
    returned) and returns (module, its tree in JAX's layout), where every
    converted layer's `weight` is int8 beside its per-output-channel
    `w_scale`; other tensors (biases, BatchNorm statistics) pass through.

    calib_batches: an optional iterable of input tuples. Each batch runs
    one calibration forward in EVAL mode (BatchNorm on its running
    statistics, no dropout: the distribution inference sees), moving
    every int8 layer's `act_scale` EMA; the frozen model then quantizes
    activations with those static scales. Without it the model quantizes
    activations dynamically. An empty iterable raises ValueError."""
    from paddle_tpu_torch.models.convert import to_jax_params
    from paddle_tpu_torch.quant.ptq import load_merged
    if variables is not None:
        load_merged(module, variables)
    module = _rewrite(module)
    if calib_batches is not None:
        device = next(module.parameters()).device
        for m in module.modules():
            if isinstance(m, INT8_LAYERS) and m.act_scale is None:
                m.act_scale = torch.zeros((), device=device)
        _set_flag(module, "calibrating", True)
        try:
            n = run_batches(module, calib_batches, training=False)
        finally:
            _set_flag(module, "calibrating", False)
        if n == 0:
            raise ValueError("freeze_int8 got an empty calib_batches — "
                             "pass None for dynamic activation scales")
        _set_flag(module, "static_act", True)
    return module, to_jax_params(module)
