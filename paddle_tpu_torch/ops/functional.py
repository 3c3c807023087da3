"""Functional op library (port of paddle_tpu/ops/functional.py):
activations, losses, reductions, elementwise ops, shape and index ops
and resizing.

Each op computes the JAX package's formula, not whatever PyTorch op
shares its name:

- `gelu` is the tanh approximation (`jax.nn.gelu`'s default);
- `softplus` is logaddexp(x, 0), with no large-x cut-off;
- `one_hot` gives a zero row for an id outside [0, depth);
- `topk` and `argsort` break ties by the lower index (a stable sort, as
  `lax.top_k` and `jnp.argsort` do);
- `gather` is `jnp.take`'s "fill" mode: ids in [-n, 0) count from the
  end, the rest out of range give NaN (the dtype's minimum for
  integers); `gather_nd` clamps, as JAX's indexing does;
- `scatter` drops out-of-range rows and counts negative ones from the
  end (`.at[].set` / `.add`); with duplicate indices which write wins
  is not defined, as in XLA;
- `elementwise_mod` is the floor mod (`torch.remainder`);
- `resize_bilinear(align_corners=False)` is `jax.image.resize`'s
  triangle filter, which antialiases when it downsamples;
- `softmax_with_cross_entropy` promotes to float32, keeps
  `ignore_index` rows at 0 and never builds a [*, V] log-softmax on the
  hard-label path.

Every op takes and returns tensors; index tensors come back int64
(PyTorch's index dtype) where JAX gives int32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

# ---------------------------------------------------------------- activations

relu = torch.relu
sigmoid = torch.sigmoid
tanh = torch.tanh


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def softsign(x):
    return x / (torch.abs(x) + 1)


def elu(x, alpha: float = 1.0):
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, alpha * torch.expm1(safe))


def gelu(x):
    """jax.nn.gelu's default, the tanh approximation."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                  * (x + 0.044715 * x ** 3)))
    return x * cdf


def silu(x):
    return x * torch.sigmoid(x)


def leaky_relu(x, alpha: float = 0.02):
    return torch.where(x >= 0, x, alpha * x)


def brelu(x, t_min: float = 0.0, t_max: float = 24.0):
    return torch.clamp(x, t_min, t_max)


def soft_relu(x, threshold: float = 40.0):
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


def hard_sigmoid(x, slope: float = 0.2, offset: float = 0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def swish(x, beta: float = 1.0):
    return x * torch.sigmoid(beta * x)


def stanh(x, scale_a: float = 0.67, scale_b: float = 1.7159):
    return scale_b * torch.tanh(scale_a * x)


def maxout(x, groups: int):
    """Max over `groups` consecutive channels per output channel."""
    c = x.shape[-1]
    return torch.amax(x.reshape(*x.shape[:-1], c // groups, groups), dim=-1)


ACTIVATIONS = {
    None: lambda x: x, "linear": lambda x: x, "relu": relu, "relu6": relu6,
    "sigmoid": sigmoid, "tanh": tanh, "softplus": softplus,
    "softsign": softsign, "elu": elu, "gelu": gelu, "silu": silu,
    "leaky_relu": leaky_relu, "swish": swish, "brelu": brelu,
    "hard_sigmoid": hard_sigmoid, "stanh": stanh, "soft_relu": soft_relu,
}


def activation(name):
    if callable(name):
        return name
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return ACTIVATIONS[name]


# -------------------------------------------------------------------- softmax

def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


# --------------------------------------------------------------------- losses

def _promote_f32(dtype: torch.dtype) -> torch.dtype:
    """jnp.promote_types(dtype, float32) for a float dtype."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _take_along(x, label, axis: int):
    """x's entries at the class ids `label` (x's shape without `axis`)."""
    idx = torch.unsqueeze(label.long(), axis)
    return torch.squeeze(torch.take_along_dim(x, idx, dim=axis), axis)


def cross_entropy(probs, label, soft_label: bool = False, axis: int = -1,
                  epsilon: float = 1e-12):
    """The cross_entropy op: `probs` is a probability distribution."""
    logp = torch.log(torch.clamp(probs, min=epsilon))
    if soft_label:
        return -torch.sum(label * logp, dim=axis)
    return -_take_along(logp, label, axis)


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               axis: int = -1, ignore_index: int = -100):
    """Fused, numerically stable softmax cross-entropy; the loss per
    example. The hard-label path is logsumexp(logits) - logits[label]
    in float32 (float64 stays): only reductions and a gather, never a
    [*, V] log-softmax; rows labelled `ignore_index` give 0."""
    f32 = _promote_f32(logits.dtype)
    if soft_label:
        logp = torch.log_softmax(logits.to(f32), dim=axis)
        return -torch.sum(label * logp, dim=axis)
    label = torch.as_tensor(label, device=logits.device).long()
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    lse = torch.logsumexp(logits.to(f32), dim=axis)
    picked = _take_along(logits, safe, axis).to(f32)
    return torch.where(valid, lse - picked, torch.zeros_like(lse))


def sigmoid_cross_entropy_with_logits(logits, label):
    ct = _promote_f32(logits.dtype)
    x = logits.to(ct)
    z = label.to(ct)
    return torch.clamp(x, min=0) - x * z + torch.log1p(torch.exp(-x.abs()))


def square_error_cost(pred, label):
    return torch.square(pred - label)


def smooth_l1(x, y, sigma: float = 1.0):
    s2 = sigma * sigma
    d = x - y
    a = torch.abs(d)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * d * d, a - 0.5 / s2)


def huber_loss(x, y, delta: float = 1.0):
    d = torch.abs(x - y)
    return torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def kldiv_loss(logp, target):
    return target * (torch.log(torch.clamp(target, min=1e-12)) - logp)


def margin_rank_loss(left, right, label, margin: float = 0.1):
    return torch.clamp(-label * (left - right) + margin, min=0.0)


def hinge_loss(logits, label):
    return torch.clamp(1.0 - (2.0 * label - 1.0) * logits, min=0.0)


def log_loss(probs, label, epsilon: float = 1e-4):
    p = torch.clamp(probs, epsilon, 1.0 - epsilon)
    return -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))


def mse_loss(pred, label):
    return torch.mean(torch.square(pred - label))


def l2_normalize(x, axis: int = -1, epsilon: float = 1e-12):
    return x * torch.rsqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                           + epsilon)


def cos_sim(a, b, axis: int = -1, epsilon: float = 1e-12):
    na = torch.sqrt(torch.sum(torch.square(a), dim=axis) + epsilon)
    nb = torch.sqrt(torch.sum(torch.square(b), dim=axis) + epsilon)
    return torch.sum(a * b, dim=axis) / (na * nb)


# ---------------------------------------------------------------- elementwise
# numpy broadcasting subsumes the reference's `axis` broadcast attribute

elementwise_add = torch.add
elementwise_sub = torch.subtract
elementwise_mul = torch.multiply
elementwise_div = torch.true_divide
elementwise_min = torch.minimum
elementwise_max = torch.maximum
elementwise_pow = torch.pow
elementwise_mod = torch.remainder          # jnp.mod: the floor mod
elementwise_floordiv = torch.floor_divide


# ----------------------------------------------------------------- reductions

def _axes(dim):
    if dim is None:
        return None
    return tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)


def _dims(x, dim):
    axes = _axes(dim)
    return tuple(range(x.dim())) if axes is None else axes


def reduce_sum(x, dim=None, keep_dim: bool = False):
    return torch.sum(x, dim=_dims(x, dim), keepdim=keep_dim)


def reduce_mean(x, dim=None, keep_dim: bool = False):
    return torch.mean(x, dim=_dims(x, dim), keepdim=keep_dim)


def reduce_max(x, dim=None, keep_dim: bool = False):
    return torch.amax(x, dim=_dims(x, dim), keepdim=keep_dim)


def reduce_min(x, dim=None, keep_dim: bool = False):
    return torch.amin(x, dim=_dims(x, dim), keepdim=keep_dim)


def reduce_prod(x, dim=None, keep_dim: bool = False):
    for d in sorted((a % x.dim() for a in _dims(x, dim)), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep_dim)
    return x


# -------------------------------------------------------------- tensor munge

def one_hot(ids, depth: int, dtype: torch.dtype = torch.float32):
    """jax.nn.one_hot: an id outside [0, depth) gives a zero row."""
    ids = torch.as_tensor(ids)
    return (ids[..., None] == torch.arange(depth, device=ids.device)).to(
        dtype)


def clip(x, min: float, max: float):
    return torch.clamp(x, min, max)


def clip_by_norm(x, max_norm: float):
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return x * torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def scale(x, scale: float = 1.0, bias: float = 0.0,
          bias_after_scale: bool = True):
    return x * scale + bias if bias_after_scale else (x + bias) * scale


def _sort(x, axis: int, descending: bool):
    """A stable sort: equal values keep their order, so ties go to the
    lower index (jnp.argsort negates for descending)."""
    return torch.sort(-x if descending else x, dim=axis, stable=True)[1]


def topk(x, k: int):
    """lax.top_k over the last axis: (values, indices), ties by the
    lower index."""
    idx = _sort(x, -1, True)[..., :k]
    return torch.take_along_dim(x, idx, dim=-1), idx


def argsort(x, axis: int = -1, descending: bool = False):
    idx = _sort(x, axis, descending)
    return torch.take_along_dim(x, idx, dim=axis), idx


def concat(xs, axis: int = 0):
    return torch.cat(list(xs), dim=axis)


def split(x, num_or_sections, axis: int = 0):
    """`num_or_sections` equal pieces, or pieces cut at the running sums
    of the sections but the last (jnp.split: the last piece takes the
    rest)."""
    n = x.shape[axis]
    if isinstance(num_or_sections, int):
        if n % num_or_sections:
            raise ValueError(f"axis of size {n} does not split into "
                             f"{num_or_sections} equal pieces")
        return list(torch.split(x, n // num_or_sections, dim=axis))
    cuts = [0]
    for s in list(num_or_sections)[:-1]:
        cuts.append(cuts[-1] + int(s))
    cuts.append(n)
    return list(torch.split(x, [b - a for a, b in zip(cuts, cuts[1:])],
                            dim=axis))


def stack(xs, axis: int = 0):
    return torch.stack(list(xs), dim=axis)


def transpose(x, perm):
    return x.permute(*perm)


def reshape(x, shape):
    return x.reshape(*shape)


def squeeze(x, axes=None):
    if axes is None:
        return torch.squeeze(x)
    if isinstance(axes, int):
        axes = (axes,)
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(f"cannot squeeze axis {a} of size {x.shape[a]}")
    return torch.squeeze(x, dim=tuple(axes))


def unsqueeze(x, axes):
    for a in sorted(_axes(axes)):
        x = torch.unsqueeze(x, a)
    return x


def expand(x, times: Sequence[int]):
    """The expand op: tile each dim by times[i]."""
    return torch.tile(x, tuple(times))


def _fill_value(dtype: torch.dtype):
    return (float("nan") if dtype.is_floating_point
            else torch.iinfo(dtype).min)


def gather(x, index, axis: int = 0):
    """jnp.take in "fill" mode along `axis`: ids in [-n, 0) count from
    the end; ids outside [-n, n) give NaN rows (integers: the dtype's
    minimum)."""
    index = torch.as_tensor(index, device=x.device).long()
    axis = axis % x.dim()
    n = x.shape[axis]
    idx = torch.where(index < 0, index + n, index)
    valid = (idx >= 0) & (idx < n)
    out = torch.index_select(x, axis, idx.clamp(0, n - 1).reshape(-1))
    out = out.reshape(*x.shape[:axis], *index.shape, *x.shape[axis + 1:])
    keep = valid.reshape((1,) * axis + tuple(index.shape)
                         + (1,) * (x.dim() - axis - 1))
    return torch.where(keep, out, torch.full_like(out, _fill_value(x.dtype)))


def _clamp_index(index, n: int):
    """JAX's indexing of one axis: negative ids count from the end,
    the result clamped to [0, n)."""
    return torch.where(index < 0, index + n, index).clamp(0, n - 1)


def gather_nd(x, index):
    index = torch.as_tensor(index, device=x.device).long()
    return x[tuple(_clamp_index(index[..., i], x.shape[i])
                   for i in range(index.shape[-1]))]


def scatter(x, index, updates, overwrite: bool = True):
    """The scatter op: write (or add) rows of `updates` at `index` of
    x's first axis. Negative ids count from the end; rows outside
    [-n, n) are dropped."""
    index = torch.as_tensor(index, device=x.device).long().reshape(-1)
    n = x.shape[0]
    idx = torch.where(index < 0, index + n, index)
    valid = (idx >= 0) & (idx < n)
    upd = updates.reshape(-1, *x.shape[1:])[valid]
    idx = idx[valid]
    if overwrite:
        return x.index_put((idx,), upd.to(x.dtype))
    return x.index_put((idx,), upd.to(x.dtype), accumulate=True)


def where(cond, x, y):
    return torch.where(torch.as_tensor(cond, device=x.device), x, y)


def cumsum(x, axis: int = 0, exclusive: bool = False, reverse: bool = False):
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if exclusive:
        out = out - x
    if reverse:
        out = torch.flip(out, (axis,))
    return out


def shard_index(ids, index_num: int, nshards: int, shard_id: int,
                ignore_value: int = -1):
    """The shard_index op: global ids to shard-local ids, or ignore."""
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(ids, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, torch.remainder(ids, shard_size),
                       torch.full_like(ids, ignore_value))


def label_smooth(label, epsilon: float = 0.1, prior=None):
    k = label.shape[-1]
    uniform = (1.0 / k) if prior is None else prior
    return (1.0 - epsilon) * label + epsilon * uniform


def pad(x, paddings, pad_value: float = 0.0):
    """The pad op: paddings = [(lo, hi), ...] per dim."""
    flat = []
    for lo, hi in reversed(list(paddings)):
        flat += [int(lo), int(hi)]
    return torch.nn.functional.pad(x, flat, value=pad_value)


def pixel_shuffle(x, upscale: int):
    n, h, w, c = x.shape
    r = upscale
    x = x.reshape(n, h, w, r, r, c // (r * r))
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def resize_nearest(x, out_shape):
    """The interpolate op (nearest), NHWC."""
    n, h, w, c = x.shape
    oh, ow = out_shape
    ridx = torch.arange(oh, device=x.device) * h // oh
    cidx = torch.arange(ow, device=x.device) * w // ow
    return x[:, ridx][:, :, cidx]


def _triangle_weights(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """jax.image.resize's [n_in, n_out] weights for "bilinear" (scale
    n_out / n_in, no translation, antialias on): the triangle kernel,
    widened by 1 / scale when downsampling, each column normalised."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * inv_scale
              - 0.5)
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]
            ).abs() / kernel_scale
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(
        dtype=dtype, device=device)


def _linspace(stop: float, num: int, dtype, device,
              start: float = 0.0) -> torch.Tensor:
    """jnp.linspace(start, stop, num) in its arithmetic:
    start * (1 - i / div) + stop * (i / div), the last point exactly
    stop; one point is [start]."""
    if num <= 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / div
    return torch.cat([torch.full((1,), start, dtype=dtype, device=device)
                      * (1 - step) + stop * step,
                      torch.full((1,), stop, dtype=dtype, device=device)])


def resize_bilinear(x, out_shape, align_corners: bool = False):
    """The interpolate op (bilinear), NHWC. align_corners=True samples
    the corner-aligned grid; False is jax.image.resize's half-pixel
    triangle filter, which antialiases when it downsamples."""
    oh, ow = out_shape
    h, w = x.shape[1], x.shape[2]
    if not align_corners:
        if h != oh:
            x = torch.einsum("nhwc,hH->nHwc", x,
                             _triangle_weights(h, oh, x.dtype, x.device))
        if w != ow:
            x = torch.einsum("nhwc,wW->nhWc", x,
                             _triangle_weights(w, ow, x.dtype, x.device))
        return x
    dt = x.dtype if x.dtype == torch.float64 else torch.float32
    ys = _linspace(h - 1.0, oh, dt, x.device)
    xs = _linspace(w - 1.0, ow, dt, x.device)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    top = x[:, y0][:, :, x0] * (1 - wx) + x[:, y0][:, :, x1] * wx
    bot = x[:, y1][:, :, x0] * (1 - wx) + x[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy
