"""Fake-quantization ops (QAT) and real int8 products (port of
paddle_tpu/quant/fake_quant.py).

- `quantize` / `dequantize`: symmetric per-tensor or per-channel int8 in
  JAX's order of operations, q = clip(round(x / max(scale, 1e-12) * r),
  -r, r) with r = 2^(bits-1) - 1 (`torch.round` rounds half to even, as
  `jnp.round` does), and x = q * scale / r.
- The fake-quant ops return qdq(x) through the straight-through
  estimator, `x + (qdq - x).detach()`: the forward is the quantized
  value, the gradient that of the identity (JAX's `stop_gradient`).
  Their scales are detached.
- `int8_matmul` quantizes both operands to int8 and multiplies them
  with `int8_mm` (`torch._int_mm`, int32 accumulation), then rescales as
  acc * (x_scale * w_scale) / r^2. JAX computes it with an int8
  `lax.dot_general` outside any Pallas kernel, so the library's int8
  GEMM is its counterpart.
"""

from __future__ import annotations

import torch

#: the 1e-12 floor of every abs-max scale (JAX's jnp.maximum(scale, 1e-12))
SCALE_FLOOR = 1e-12


def qrange(bits: int) -> float:
    """Symmetric quantization range: [-2^(b-1)+1, 2^(b-1)-1]."""
    return float((1 << (bits - 1)) - 1)


def _as_scale(scale, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32, device=like.device)


def quantize(x: torch.Tensor, scale, bits: int = 8) -> torch.Tensor:
    """Real quantization to integers held in float: round to nearest
    (half to even), clamped to [-r, r]."""
    r = qrange(bits)
    q = torch.round(x / _as_scale(scale, x).clamp_min(SCALE_FLOOR) * r)
    return q.clamp(-r, r)


def dequantize(q: torch.Tensor, scale, bits: int = 8) -> torch.Tensor:
    return q.float() * _as_scale(scale, q) / qrange(bits)


def _ste(x: torch.Tensor, qdq: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward qdq(x), gradient of identity."""
    return x + (qdq - x).detach()


def abs_max_scale(x: torch.Tensor, axis=None,
                  keepdims: bool = False) -> torch.Tensor:
    if axis is None:
        m = x.abs().amax()
        return m.reshape([1] * x.dim()) if keepdims else m
    return x.abs().amax(dim=axis, keepdim=keepdims)


def fake_quant_abs_max(x: torch.Tensor, bits: int = 8):
    """Per-tensor fake quant with the current abs-max as scale. Returns
    (qdq_x, scale); differentiable through the STE."""
    scale = abs_max_scale(x).detach()
    qdq = dequantize(quantize(x, scale, bits), scale, bits)
    return _ste(x, qdq), scale


def fake_quant_channel_abs_max(w: torch.Tensor, bits: int = 8,
                               axis: int = -1):
    """Per-output-channel weight fake quant. `axis` is the weight's
    output-channel dim (last for both [in, out] dense and HWIO conv).
    Returns (qdq_w, scales squeezed)."""
    red = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    scale = abs_max_scale(w, axis=red, keepdims=True).detach()
    qdq = dequantize(quantize(w, scale, bits), scale, bits)
    return _ste(w, qdq), scale.squeeze()


def fake_quant_moving_average(x: torch.Tensor, running_scale,
                              bits: int = 8, momentum: float = 0.9,
                              update: bool = True):
    """Activation fake quant with an EMA abs-max scale. Returns (qdq_x,
    new_scale): with `update` the scale moves to momentum * running +
    (1 - momentum) * abs-max (the first batch, running 0, takes the
    abs-max); `update=False` (inference) keeps it. A zero scale falls
    back to the batch's abs-max for this call."""
    cur = abs_max_scale(x).detach()
    running = _as_scale(running_scale, x)
    if update:
        new_scale = torch.where(running > 0,
                                momentum * running + (1.0 - momentum) * cur,
                                cur)
    else:
        new_scale = running
    use = torch.where(new_scale > 0, new_scale, cur).detach()
    qdq = dequantize(quantize(x, use, bits), use, bits)
    return _ste(x, qdq), new_scale


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N] through `torch._int_mm`.
    On CUDA, cuBLASLt's int8 kernels take the "TN" layout (both operands
    K-major), so `b` goes in column-major; `_int_mm` also needs M > 16
    and K, N multiples of 8: shapes short of that are zero padded (zeros
    add nothing to an int32 sum, so the result is exact) and the padding
    cut off again."""
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch._int_mm(a.contiguous(), b.contiguous())
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n] if pm or pn else out


def int8_matmul(x: torch.Tensor, w: torch.Tensor, x_scale, w_scale,
                bits: int = 8) -> torch.Tensor:
    """Real int8 x int8 -> int32 matmul with an f32 rescale. x [..., K]
    f32, w [K, N] f32; scales per tensor (x) and per channel [N] or
    scalar (w)."""
    r = qrange(bits)
    qx = quantize(x, x_scale, bits).to(torch.int8)
    qw = quantize(w, w_scale, bits).to(torch.int8)
    acc = int8_mm(qx.reshape(-1, qx.shape[-1]), qw)
    acc = acc.reshape(*qx.shape[:-1], qw.shape[-1])
    return acc.float() * (_as_scale(x_scale, x) * _as_scale(w_scale, x)) \
        / (r * r)
