"""The dense, convolution, pooling and normalisation layers (port of
paddle_tpu/nn/layers.py).

Parameter layout and numerics follow the JAX layers so weights carry
across unchanged (models/convert.py). A layer makes its parameters in
`__init__`, so it takes its input width first (JAX infers it on first
use); names and shapes are JAX's:

- `Linear` keeps the `[in, out]` weight layout and computes
  `x @ w + b` in the layer's compute dtype (JAX `Linear.forward`).
- `Embedding` holds a `[V, D]` table; `attend` is the tied output head
  `x @ table.T`.
- `LayerNorm` computes in float32 with eps 1e-5 and returns the input
  dtype; its parameters are named `scale` and `bias` as in JAX.
- `Dropout` is the identity in eval mode and upscale-in-train dropout
  when training, drawing its bits from the `torch.Generator` the caller
  passes (never from PyTorch's global RNG).
- The convolutions take NHWC / NDHWC tensors and keep JAX's HWIO /
  DHWIO kernels ([kh, kw, in/groups, out]). cuDNN is fed the input's
  channels-last view (`x.movedim(-1, 1)` of an NHWC-contiguous tensor
  needs no copy) and the kernel as [out, in/groups, kh, kw] in
  channels-last memory; the output is moved back to NHWC as a view.
- `BatchNorm` and `DataNorm` keep their running statistics in
  persistent buffers under JAX's `state` names (`mean`, `var`; `count`,
  `sum`, `sumsq`), updated in place in training mode.

Where JAX's lax op and the PyTorch op of the same name differ, the JAX
formula is computed:

- `"SAME"` padding is lax's: total = max((ceil(n / s) - 1) s + (k - 1)
  d + 1 - n, 0), lo = total // 2, hi = total - lo, which is
  asymmetric for a stride above 1. cuDNN takes the symmetric part and
  `F.pad` the remainder, on the NHWC tensor before the view.
- `Conv2DTranspose` / `Conv3DTranspose` are `lax.conv_transpose` with
  `transpose_kernel=False`: a correlation of the stride-dilated input,
  padded by lax's `_conv_transpose_padding` (or the explicit pairs),
  with the kernel as it is. That is `F.conv_transpose*d` with the
  kernel flipped in every spatial axis and laid out [in, out, ...],
  whose full output is then cropped (or zero-extended) to lax's window.
- The max pools pad with -inf (lax's init value) and the average pools
  with zeros, asymmetrically under `"SAME"`; `avg_pool2d` divides by
  the window's size, or with `count_include_pad=False` by the count of
  real elements it covers.
- `lrn` is k + alpha * sum (not alpha / n) over a channel window padded
  (n // 2, n - 1 - n // 2), in float32.
- `BatchNorm`'s batch variance is max(E[x^2] - E[x]^2, 0) in float32,
  and its running stats move as m * running + (1 - m) * batch (m 0.9)
  with the biased batch variance (`F.batch_norm` would store the
  unbiased one).

Parameters are stored in float32, as JAX's `param_dtype` does, and are
cast to the compute dtype where they are used.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.nn import initializers as I
from paddle_tpu_torch.nn.fused_bn import bn_relu_train


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def normalize_padding(pad, nd: int = 2):
    """Conv padding in its lax form: "SAME"/"VALID" pass through; an int,
    or one int a spatial dim, becomes explicit per-dim (lo, hi) pairs."""
    if isinstance(pad, int):
        return [(pad, pad)] * nd
    if isinstance(pad, (tuple, list)) and isinstance(pad[0], int):
        return [(p, p) for p in pad]
    return pad


# ------------------------------------------------------------- padding

def same_pads(sizes: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int], dilation: Sequence[int] = None
              ) -> list:
    """lax's "SAME" (lo, hi) per spatial dim."""
    dilation = dilation or (1,) * len(sizes)
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _spatial_pads(padding, sizes, kernel, stride, dilation=None) -> list:
    """A padding in any form lax accepts (a string, an int, per-dim ints,
    or explicit (lo, hi) pairs) as (lo, hi) per spatial dim."""
    nd = len(sizes)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * nd
        if padding.upper() == "SAME":
            return same_pads(sizes, kernel, stride, dilation)
        raise ValueError(f"unknown padding {padding!r}")
    padding = [tuple(p) for p in normalize_padding(padding, nd)]
    if len(padding) != nd:
        raise ValueError(f"padding {padding} for {nd} spatial dims")
    return padding


def _pad_nhwc(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """F.pad of the spatial dims of a channels-last tensor [N, *S, C]
    (negative pads crop)."""
    if all(lo == 0 and hi == 0 for lo, hi in pads):
        return x
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _split_pads(pads):
    """(the symmetric part cuDNN takes, the remainder for F.pad)."""
    sym = [min(lo, hi) if lo >= 0 and hi >= 0 else 0 for lo, hi in pads]
    rest = [(lo - s, hi - s) for (lo, hi), s in zip(pads, sym)]
    return sym, rest


def _kernel_cl(weight: torch.Tensor, first: int, second: int,
               dtype: torch.dtype) -> torch.Tensor:
    """A kernel [*k, a, b] as the [dim first, dim second, *k] view cuDNN
    takes, in channels-last memory ([first, *k, second] contiguous),
    cast to `dtype`: one copy."""
    nd = weight.dim() - 2
    w = weight.permute(first, *range(nd), second)
    w = w.to(dtype=dtype, memory_format=torch.contiguous_format)
    return w.contiguous().movedim(-1, 1)


_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


def conv_nd(x: torch.Tensor, weight: torch.Tensor, stride, padding,
            dilation, groups: int, dtype: torch.dtype) -> torch.Tensor:
    """lax.conv_general_dilated over channels-last x [N, *S, C] and a
    [*k, C/groups, O] kernel, in `dtype`: the output [N, *S', O]."""
    nd = weight.dim() - 2
    pads = _spatial_pads(padding, x.shape[1:1 + nd], weight.shape[:nd],
                         stride, dilation)
    sym, rest = _split_pads(pads)
    x = _pad_nhwc(x.to(dtype), rest)
    w = _kernel_cl(weight, nd + 1, nd, dtype)
    y = _CONV[nd](x.movedim(-1, 1), w, None, tuple(stride), tuple(sym),
                  tuple(dilation), groups)
    return y.movedim(1, -1)


def conv_transpose_padding(k: int, s: int, padding) -> Tuple[int, int]:
    """lax's `_conv_transpose_padding` for one dim: the (lo, hi) pads of
    the stride-dilated input for "SAME" / "VALID"."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"invalid padding mode {padding!r}")
    return pad_a, pad_len - pad_a


def conv_transpose_nd(x: torch.Tensor, weight: torch.Tensor, stride,
                      padding, dtype: torch.dtype) -> torch.Tensor:
    """lax.conv_transpose(transpose_kernel=False) over channels-last x
    [N, *S, C] and a [*k, C, O] kernel: F.conv_transpose*d with the
    kernel flipped spatially as [C, O, *k], its full output (implicit
    pads k - 1) then cropped or zero-extended to lax's pads."""
    nd = weight.dim() - 2
    k = weight.shape[:nd]
    if isinstance(padding, str):
        pads = [conv_transpose_padding(kk, s, padding.upper())
                for kk, s in zip(k, stride)]
    else:
        pads = [tuple(p) for p in padding]
    w = _kernel_cl(weight.flip(tuple(range(nd))), nd, nd + 1, dtype)
    y = _CONV_T[nd](x.to(dtype).movedim(-1, 1), w, None, tuple(stride))
    adjust = [(lo - (kk - 1), hi - (kk - 1)) for (lo, hi), kk in zip(pads, k)]
    return _pad_nhwc(y.movedim(1, -1), adjust)


# --------------------------------------------------------------- dense

class Linear(nn.Module):
    """Fully-connected layer: y = x @ weight + bias, weight [in, out].
    Without `kernel_init` the weight is glorot-uniform from PyTorch's
    default generator (JAX's default distribution)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, kernel_init=None, bias_init=None,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = dtype
        if kernel_init is None:
            self.weight = nn.Parameter(
                torch.empty(in_features, out_features, device=device))
            nn.init.xavier_uniform_(self.weight)
        else:
            self.weight = I.parameter(kernel_init, (in_features, out_features),
                                      device)
        self.bias = None
        if use_bias:
            self.bias = (
                nn.Parameter(torch.zeros(out_features, device=device))
                if bias_init is None
                else I.parameter(bias_init, (out_features,), device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = self._qtransform(x, self.weight)
        y = torch.matmul(x.to(self.dtype), w.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y

    def _qtransform(self, x: torch.Tensor, w: torch.Tensor):
        """Hook for input / weight transforms (a quantized subclass
        overrides it with the fake-quant pair); the identity here."""
        return x, w


class Embedding(nn.Module):
    """Token lookup into a [V, D] table, plus the tied output head.
    `padding_idx` rows read as zeros; without `embedding_init` the table
    is N(0, 0.02) from PyTorch's default generator."""

    def __init__(self, num_embeddings: int, features: int,
                 padding_idx: Optional[int] = None, embedding_init=None,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.padding_idx = padding_idx
        self.dtype = dtype
        if embedding_init is None:
            self.weight = nn.Parameter(
                torch.empty(num_embeddings, features, device=device))
            nn.init.normal_(self.weight, 0.0, 0.02)
        else:
            self.weight = I.parameter(embedding_init,
                                      (num_embeddings, features), device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """JAX's `jnp.take` in its default "fill" mode: ids in [-V, 0)
        count from the end, ids outside [-V, V) give a row of NaN. A
        clamped gather and a select, so a bad id neither raises nor
        syncs the host (on CUDA an out-of-range index is a device-side
        assert), and a NaN row sends no gradient to the table. Then the
        `padding_idx` rows (compared on the ids as given) become 0."""
        v = self.num_embeddings
        norm = torch.where(ids < 0, ids + v, ids)
        valid = (norm >= 0) & (norm < v)
        rows = self.weight[norm.clamp(0, v - 1)].to(self.dtype)
        out = torch.where(valid[..., None], rows, float("nan"))
        if self.padding_idx is not None:
            out = torch.where((ids != self.padding_idx)[..., None], out,
                              torch.zeros_like(out))
        return out

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-softmax projection: x @ table.T (LM output heads)."""
        return torch.matmul(x.to(self.dtype), self.weight.t().to(self.dtype))


class Dropout(nn.Module):
    """Identity in eval mode; upscale-in-train dropout when training
    (JAX Dropout, nn/layers.py:474): keep with probability 1 - rate and
    scale the kept values by 1 / (1 - rate). The keep bits come from
    `generator`, which training with rate > 0 requires (JAX's
    `cx.rng()`); the bits differ from JAX's bernoulli draw."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout in training needs a torch.Generator")
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


# -------------------------------------------------------- convolutions

class Conv2D(nn.Module):
    """2-D convolution over NHWC; weight [kh, kw, in/groups, out]
    (kaiming-normal), bias [out] (zeros). `padding` takes "SAME",
    "VALID", an int, an (h, w) pair or explicit (lo, hi) pairs."""

    _expand = staticmethod(_pair)

    def __init__(self, in_features: int, features: int, kernel_size,
                 stride=1, padding="SAME", dilation=1, groups: int = 1,
                 use_bias: bool = True, kernel_init=None, bias_init=None,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        if in_features % groups:
            raise ValueError(f"{in_features} input features not divisible "
                             f"by {groups} groups")
        self.features = features
        self.kernel_size = self._expand(kernel_size)
        self.stride = self._expand(stride)
        self.dilation = self._expand(dilation)
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.weight = I.parameter(kernel_init or I.kaiming_normal,
                                  (*self.kernel_size, in_features // groups,
                                   features), device)
        self.bias = (I.parameter(bias_init or I.zeros, (features,), device)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = self._qtransform(x, self.weight)
        y = conv_nd(x, w, self.stride, self.padding, self.dilation,
                    self.groups, self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y

    def _qtransform(self, x: torch.Tensor, w: torch.Tensor):
        """Hook for input / weight transforms (see Linear._qtransform)."""
        return x, w


class Conv3D(Conv2D):
    """3-D convolution over NDHWC; weight [kd, kh, kw, in/groups, out]."""

    _expand = staticmethod(_triple)


class Conv2DTranspose(nn.Module):
    """Transposed 2-D conv over NHWC (`lax.conv_transpose`); weight [kh,
    kw, in, out] (glorot-uniform). `padding` is "SAME", "VALID" or
    explicit (lo, hi) pairs of the stride-dilated input."""

    _expand = staticmethod(_pair)

    def __init__(self, in_features: int, features: int, kernel_size,
                 stride=1, padding="SAME", use_bias: bool = True,
                 kernel_init=None, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.features = features
        self.kernel_size = self._expand(kernel_size)
        self.stride = self._expand(stride)
        self.padding = padding
        self.dtype = dtype
        self.weight = I.parameter(kernel_init or I.glorot_uniform,
                                  (*self.kernel_size, in_features, features),
                                  device)
        self.bias = (I.parameter(I.zeros, (features,), device)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_transpose_nd(x, self.weight, self.stride, self.padding,
                              self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Conv3DTranspose(Conv2DTranspose):
    """Transposed 3-D conv over NDHWC; weight [kd, kh, kw, in, out]."""

    _expand = staticmethod(_triple)


# --------------------------------------------------------------- pools

def _pool_pads(x: torch.Tensor, padding, window, stride) -> list:
    """reduce_window's padding (a string, or (lo, hi) for every dim of x)
    as (lo, hi) per spatial dim."""
    nd = len(window)
    if isinstance(padding, str):
        return _spatial_pads(padding, x.shape[1:1 + nd], window, stride)
    pads = [tuple(p) for p in padding]
    if len(pads) != x.dim() or pads[0] != (0, 0) or pads[-1] != (0, 0):
        raise ValueError(f"pool padding {padding}: one (lo, hi) pair for "
                         f"each of the {x.dim()} dims, 0 on batch and "
                         "channels")
    return pads[1:-1]


def _sum_pool(x: torch.Tensor, pads, window, stride) -> torch.Tensor:
    """Window sums of channels-last x under zero padding."""
    pool = F.avg_pool2d if len(window) == 2 else F.avg_pool3d
    y = pool(_pad_nhwc(x, pads).movedim(-1, 1), tuple(window), tuple(stride),
             divisor_override=1)
    return y.movedim(1, -1)


def _max_pool(x, window, stride, padding):
    pads = _pool_pads(x, padding, window, stride)
    pool = F.max_pool2d if len(window) == 2 else F.max_pool3d
    y = pool(_pad_nhwc(x, pads, float("-inf")).movedim(-1, 1),
             tuple(window), tuple(stride))
    return y.movedim(1, -1)


def max_pool2d(x, window, stride=None, padding="VALID"):
    """Max pool over NHWC; padded cells are -inf."""
    window = _pair(window)
    return _max_pool(x, window, _pair(stride if stride is not None
                                      else window), padding)


def avg_pool2d(x, window, stride=None, padding="VALID",
               count_include_pad: bool = True):
    """Average pool over NHWC: window sums over zero padding, divided by
    the window's size, or (count_include_pad=False, padded) by the count
    of real elements in the window."""
    window = _pair(window)
    stride = _pair(stride if stride is not None else window)
    pads = _pool_pads(x, padding, window, stride)
    summed = _sum_pool(x, pads, window, stride)
    if count_include_pad or padding == "VALID":
        return summed / (window[0] * window[1])
    ones = torch.ones(x.shape[:3] + (1,), dtype=x.dtype, device=x.device)
    return summed / _sum_pool(ones, pads, window, stride)


def global_avg_pool2d(x):
    """NHWC -> [N, C]: the mean over H and W."""
    return torch.mean(x, dim=(1, 2))


def max_pool3d(x, window, stride=None, padding="VALID"):
    """Max pool over NDHWC."""
    window = _triple(window)
    return _max_pool(x, window, _triple(stride if stride is not None
                                        else window), padding)


def avg_pool3d(x, window, stride=None, padding="VALID"):
    """Average pool over NDHWC (divides by the window's size)."""
    window = _triple(window)
    stride = _triple(stride if stride is not None else window)
    summed = _sum_pool(x, _pool_pads(x, padding, window, stride), window,
                       stride)
    return summed / (window[0] * window[1] * window[2])


def lrn(x, n: int = 5, k: float = 1.0, alpha: float = 1e-4,
        beta: float = 0.75):
    """Local response normalisation across the last (channel) axis:
    x / (k + alpha * sum over a window of n channels of x^2)^beta, the
    window padded (n // 2, n - 1 - n // 2), in float32."""
    sq = x.float().square()
    c = x.shape[-1]
    half = n // 2
    padded = F.pad(sq, (half, n - 1 - half))
    total = padded[..., 0:c]
    for i in range(1, n):
        total = total + padded[..., i:i + c]
    denom = k + alpha * total
    return (x.float() / torch.pow(denom, beta)).to(x.dtype)


# ------------------------------------------------------- normalisation

class LayerNorm(nn.Module):
    """Layer normalisation over the last axis, computed in float32;
    returns `dtype` (default the input's)."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 scale: bool = True, center: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = (nn.Parameter(torch.ones(features, device=device))
                      if scale else None)
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if center else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        if self.scale is not None:
            y = y * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype or x.dtype)


class GroupNorm(nn.Module):
    """Group normalisation over NHWC: channels split into `groups` runs
    of C / groups, each normalised over (spatial, its channels)."""

    def __init__(self, features: int, groups: int = 32,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        if features % groups:
            raise ValueError(f"{features} features not divisible by "
                             f"{groups} groups")
        self.groups = groups
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        shape = x.shape
        xf = x.float().reshape(*shape[:-1], g, shape[-1] // g)
        axes = tuple(range(1, xf.dim() - 2)) + (xf.dim() - 1,)
        mean = xf.mean(dim=axes, keepdim=True)
        var = (xf - mean).square().mean(dim=axes, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.epsilon)).reshape(shape)
        y = y * self.scale + self.bias
        return y.to(self.dtype or x.dtype)


class DataNorm(nn.Module):
    """Streaming feature normalisation by accumulated totals (data_norm):
    (x - sum / count) / sqrt(max(sumsq / count - mean^2, 0) + eps), with
    the totals from BEFORE this batch. Persistent buffers `count` (a
    scalar, init 1), `sum` (zeros) and `sumsq` (ones); training adds the
    batch's row count, sums and sums of squares in place."""

    def __init__(self, features: int, epsilon: float = 1e-4,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer("count", torch.ones((), device=device))
        self.register_buffer("sum", torch.zeros(features, device=device))
        self.register_buffer("sumsq", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = self.sum / self.count
        var = torch.clamp(self.sumsq / self.count - mean.square(), min=0.0)
        y = (x.float() - mean) * torch.rsqrt(var + self.epsilon)
        if self.training:
            with torch.no_grad():
                xf = x.detach().float().reshape(-1, x.shape[-1])
                self.count.add_(xf.shape[0])
                self.sum.add_(xf.sum(dim=0))
                self.sumsq.add_(xf.square().sum(dim=0))
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """Batch normalisation with running statistics, features on `axis`.

    Persistent buffers `mean` (zeros) and `var` (ones) hold the running
    stats, JAX's `state`; parameters `scale` / `bias` as `scale` /
    `center` ask. In training mode (`module.training`) the batch stats
    normalise and the buffers move in place to m * running + (1 - m) *
    batch; `use_running_stats` overrides the choice of stats. With
    `fuse_relu` the layer ends in a ReLU, through `bn_relu_train` (which
    saves only its output-side tensors for backward) when training on
    batch stats with the features last, scale and center.

    `axis_name` (an axis or a tuple of axes of the current mesh, the one
    MeshTrainer enters) is sync-BN: the batch mean and E[x^2] are
    averaged over those ranks, with gradient, before the variance is
    taken (JAX's pmean, nn/layers.py:399-401); `fuse_relu` then takes
    the unfused path, as in JAX. With no mesh current it raises
    NameError, as JAX's unbound axis does. Without `axis_name` a rank's
    statistics are its own batch's."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, scale: bool = True,
                 center: bool = True, axis: int = -1,
                 dtype: Optional[torch.dtype] = None,
                 axis_name: Optional[str] = None, fuse_relu: bool = False,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.axis_name = axis_name
        self.momentum = momentum
        self.epsilon = epsilon
        self.axis = axis
        self.dtype = dtype
        self.fuse_relu = fuse_relu
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.scale = (nn.Parameter(torch.ones(features, device=device))
                      if scale else None)
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if center else None)

    def _sync(self, stats: torch.Tensor) -> torch.Tensor:
        """`stats` averaged over the ranks of `axis_name` on the current
        mesh, with gradient."""
        from paddle_tpu_torch.parallel.collective import all_reduce_mean
        from paddle_tpu_torch.parallel.mesh import current_mesh
        mesh = current_mesh()
        if mesh is None:
            raise NameError(f"unbound axis name: {self.axis_name!r} (no "
                            "mesh is current; MeshTrainer enters one)")
        group = mesh.maybe_group(self.axis_name)
        return stats if group is None else all_reduce_mean(stats, group)

    @torch.no_grad()
    def _update_ema(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * mean.detach())
        self.var.copy_(m * self.var + (1 - m) * var.detach())

    def forward(self, x: torch.Tensor,
                use_running_stats: Optional[bool] = None) -> torch.Tensor:
        ax = self.axis % x.dim()
        use_running = (not self.training if use_running_stats is None
                       else use_running_stats)
        if (self.fuse_relu and not use_running and self.scale is not None
                and self.bias is not None and ax == x.dim() - 1
                and self.axis_name is None):
            y, mean, var = bn_relu_train(x, self.scale.float(),
                                         self.bias.float(),
                                         float(self.epsilon))
            if self.training:
                self._update_ema(mean, var)
            return y.to(self.dtype or x.dtype)
        shape = [x.shape[ax] if i == ax else 1 for i in range(x.dim())]
        xf = x.float()
        if use_running:
            mean, var = self.mean, self.var
        else:
            axes = tuple(i for i in range(x.dim()) if i != ax)
            mean = xf.mean(dim=axes)
            mean2 = xf.square().mean(dim=axes)
            if self.axis_name is not None:
                mean, mean2 = self._sync(torch.stack([mean, mean2]))
            var = torch.clamp(mean2 - mean.square(), min=0.0)
            if self.training:
                self._update_ema(mean, var)
        inv = torch.rsqrt(var.float() + self.epsilon)
        y = (xf - mean.reshape(shape)) * inv.reshape(shape)
        if self.scale is not None:
            y = y * self.scale.reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        if self.fuse_relu:
            y = torch.relu(y)
        return y.to(self.dtype or x.dtype)
