"""Long-tail op library (port of paddle_tpu/ops/extras.py): vision warps,
pooling with indices, losses, sampling and tensor utilities. Image ops
are NHWC, as JAX's are.

JAX's formulas, where a PyTorch op of the same name differs:

- `max_pool2d_with_index` / `_3d` take a value only when it is strictly
  greater than the window's best so far (XLA's reducer `bv > av` from
  (-inf, 0)): the first maximum wins, a NaN is never taken, and a
  window of NaN / -inf only gives (-inf, 0). `F.max_pool2d` propagates
  NaN;
- `hash_embedding_ids` is uint32 arithmetic that wraps, computed in
  int64 and cut to 32 bits after each multiply and add; a negative id
  or one >= 2^32 is taken modulo 2^32 first;
- `max_unpool2d`, `center_loss` and `mean_iou` accumulate into repeated
  indices (`scatter_add_` / `index_add_`);
- `grid_sampler` is align-corners bilinear sampling with each corner
  outside the image read as zero;
- `pad2d`'s "edge" is PyTorch's "replicate".

The random ops take a `torch.Generator` where JAX takes a key and draw
on its device; their draws differ from JAX's. Index outputs are int64
where JAX's are int32.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.functional import _linspace

# ------------------------------------------------------------ vision warps


def affine_grid(theta, out_shape: Tuple[int, int]):
    """Sampling grid of 2x3 affine matrices: theta [B, 2, 3] -> grid
    [B, H, W, 2] in [-1, 1] coordinates."""
    h, w = out_shape
    dt, dev = theta.dtype, theta.device
    ys = _linspace(1.0, h, dt, dev, start=-1.0)
    xs = _linspace(1.0, w, dt, dev, start=-1.0)
    xg, yg = torch.meshgrid(xs, ys, indexing="xy")
    base = torch.stack([xg, yg, torch.ones_like(xg)], dim=-1)
    return torch.einsum("hwk,bjk->bhwj", base, theta)


def _gather_hw(x, yi, xi):
    """x [B, H, W, C] at integer positions yi, xi [B, ...] -> [B, ..., C]."""
    b, h, w, c = x.shape
    flat = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
    return torch.gather(x.reshape(b, h * w, c), 1, flat).reshape(
        *yi.shape, c)


def grid_sampler(x, grid):
    """Bilinear sampling of x [B, H, W, C] at grid [B, Hg, Wg, 2] ([-1, 1]
    xy coordinates, corners aligned); a corner outside reads zero."""
    _, h, w, _ = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]

    def corner(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = _gather_hw(x, torch.clamp(yi, 0, h - 1).long(),
                          torch.clamp(xi, 0, w - 1).long())
        return torch.where(inside[..., None], vals, torch.zeros_like(vals))

    top = corner(y0, x0) * (1 - wx) + corner(y0, x1) * wx
    bot = corner(y1, x0) * (1 - wx) + corner(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def affine_channel(x, scale, bias):
    """Per-channel x * scale + bias (frozen batch norm); x [..., C]."""
    return x * scale + bias


def shuffle_channel(x, groups: int):
    """ShuffleNet's channel shuffle, NHWC."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups)
    return x.transpose(3, 4).reshape(n, h, w, c)


def space_to_depth(x, block: int):
    """NHWC space-to-depth rearrangement."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def depth_to_space(x, block: int):
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, block, block, c // (block * block))
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * block, w * block, c // (block * block))


def _first_strict_max(windows, positions):
    """XLA's pool-with-index reducer over the last axis of `windows`:
    from (-inf, 0), take (v, pos) only where v > best. Returns (max,
    flat position)."""
    v = torch.where(torch.isnan(windows),
                    torch.full_like(windows, -math.inf), windows)
    arg = torch.argmax(v, dim=-1, keepdim=True)
    out = torch.gather(windows, -1, arg)[..., 0]
    pos = torch.gather(positions.expand_as(windows), -1, arg)[..., 0]
    taken = torch.gather(v, -1, arg)[..., 0] > -math.inf
    return (torch.where(taken, out, torch.full_like(out, -math.inf)),
            torch.where(taken, pos, torch.zeros_like(pos)))


def max_pool2d_with_index(x, kernel: int, stride: int):
    """Max pool (VALID) with the flat h*W+w position of each window's
    first maximum: x [B, H, W, C] -> (out, idx int64)."""
    _, h, w, _ = x.shape
    win = x.unfold(1, kernel, stride).unfold(2, kernel, stride)
    win = win.flatten(-2)                       # [B, OH, OW, C, k*k]
    pos = (torch.arange(h, device=x.device)[:, None] * w
           + torch.arange(w, device=x.device)[None, :])
    pos = pos.unfold(0, kernel, stride).unfold(1, kernel, stride)
    pos = pos.flatten(-2)[None, :, :, None, :]  # [1, OH, OW, 1, k*k]
    return _first_strict_max(win, pos)


def max_pool3d_with_index(x, kernel: int, stride: int):
    """3-D max pool (VALID) with the flat d*H*W + h*W + w position of
    each window's first maximum: x [B, D, H, W, C] -> (out, idx)."""
    _, d, h, w, _ = x.shape
    win = x.unfold(1, kernel, stride).unfold(2, kernel, stride).unfold(
        3, kernel, stride).flatten(-3)          # [B, OD, OH, OW, C, k^3]
    dev = x.device
    pos = (torch.arange(d, device=dev)[:, None, None] * (h * w)
           + torch.arange(h, device=dev)[None, :, None] * w
           + torch.arange(w, device=dev)[None, None, :])
    pos = pos.unfold(0, kernel, stride).unfold(1, kernel, stride).unfold(
        2, kernel, stride).flatten(-3)[None, :, :, :, None, :]
    return _first_strict_max(win, pos)


def _drop_out_of_range(idx, n: int, vals):
    """`.at[idx].add(vals)`'s index rules: negative ids count from the
    end, the rest out of range are dropped (index 0, value 0)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    return (torch.where(ok, idx, torch.zeros_like(idx)),
            torch.where(ok, vals, torch.zeros_like(vals)))


def max_unpool2d(y, idx, out_hw: Tuple[int, int]):
    """Scatter-add pooled values back to their flat positions: y / idx
    [B, Hp, Wp, C] -> [B, H, W, C]."""
    b, hp, wp, c = y.shape
    h, w = out_hw
    i, v = _drop_out_of_range(idx.reshape(b, hp * wp, c), h * w,
                              y.reshape(b, hp * wp, c))
    flat = torch.zeros((b, h * w, c), dtype=y.dtype, device=y.device)
    return flat.scatter_add(1, i, v).reshape(b, h, w, c)


def spp(x, levels: Sequence[int] = (1, 2, 4), pool_type: str = "max"):
    """Spatial pyramid pooling: x [B, H, W, C] -> [B, sum(l*l)*C]."""
    b, h, w, c = x.shape
    outs = []
    for lvl in levels:
        ph, pw = h // lvl, w // lvl
        xr = x[:, :ph * lvl, :pw * lvl].reshape(b, lvl, ph, lvl, pw, c)
        pooled = (torch.amax(xr, dim=(2, 4)) if pool_type == "max"
                  else torch.mean(xr, dim=(2, 4)))
        outs.append(pooled.reshape(b, -1))
    return torch.cat(outs, dim=1)


def im2sequence(x, kernel: Tuple[int, int], stride: Tuple[int, int]):
    """Image -> patch sequence in raster order: [B, H, W, C] ->
    [B, N_patches, C*kh*kw], each patch channel-major as
    `lax.conv_general_dilated_patches` orders it."""
    (kh, kw), (sh, sw) = kernel, stride
    p = x.unfold(1, kh, sh).unfold(2, kw, sw)   # [B, OH, OW, C, kh, kw]
    b, oh, ow = p.shape[:3]
    return p.reshape(b, oh * ow, -1)


def random_crop_op(rng: torch.Generator, x, crop_shape: Tuple[int, ...]):
    """Random crop of x's trailing dims to `crop_shape`, one offset per
    dim drawn from `rng`, the same across the leading dims."""
    nd = len(crop_shape)
    for i, cs in enumerate(crop_shape):
        axis = x.ndim - nd + i
        start = torch.randint(0, x.shape[axis] - cs + 1, (1,), generator=rng,
                              device=rng.device).to(x.device)
        x = x.index_select(axis, start + torch.arange(cs, device=x.device))
    return x


def similarity_focus(x, axis: int, indexes: Sequence[int]):
    """0/1 focus mask: for each selected channel, the positions that are
    their row's or their column's maximum. x [B, H, W, C], axis 3."""
    if axis != 3:
        raise NotImplementedError("NHWC channel focus only")
    mask = torch.zeros_like(x)
    for ch in indexes:
        plane = x[..., ch]
        row_max = plane == torch.amax(plane, dim=2, keepdim=True)
        col_max = plane == torch.amax(plane, dim=1, keepdim=True)
        mask[..., ch] = (row_max | col_max).to(x.dtype)
    return mask


# ----------------------------------------------------------- param'd ops

def prelu(x, alpha):
    """alpha a scalar, per channel [C] or elementwise."""
    return torch.where(x >= 0, x, alpha * x)


def selu(x, scale: float = 1.0507009873554805,
         alpha: float = 1.6732632423543772):
    return scale * torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


def row_conv(x, weight):
    """Lookahead row convolution (Deep Speech): x [B, T, D], weight
    [future_context + 1, D]; y[t] = sum_k w[k] * x[t + k]."""
    ctx, t = weight.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, 0, ctx - 1))
    out = torch.zeros_like(x)
    for k in range(ctx):
        out = out + pad[:, k:k + t] * weight[k][None, None, :]
    return out


def conv_shift(x, y):
    """Circular correlation: x [B, M], y [B, N] (N odd, N <= M);
    out[i] = sum_j y[j] * x[(i + j - N//2) mod M]."""
    n = y.shape[1]
    half = n // 2
    return sum(torch.roll(x, half - j, dims=1) * y[:, j:j + 1]
               for j in range(n))


def bilinear_tensor_product(x, y, weight, bias=None):
    """out[:, k] = x W_k y^T; x [B, M], y [B, N], weight [K, M, N]."""
    out = torch.einsum("bm,kmn,bn->bk", x, weight, y)
    return out + bias if bias is not None else out


def add_position_encoding(x, alpha: float = 1.0, beta: float = 1.0):
    """alpha * x + beta * the sinusoid encoding (computed in float32, as
    JAX's is); x [B, T, D]."""
    _, t, d = x.shape
    dev = x.device
    pos = torch.arange(t, dtype=torch.float32, device=dev)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=dev)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=dev), 2 * i / d)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return alpha * x + beta * pe[None, :, :d].to(x.dtype)


def multiplex(index, inputs):
    """out[b] = inputs[index[b]][b]; inputs a list of [B, D]."""
    stacked = torch.stack(list(inputs), dim=0)
    idx = index.long()[None, :, None].expand(1, -1, stacked.shape[2])
    return torch.gather(stacked, 0, idx)[0]


# ----------------------------------------------------------------- losses

def rank_loss(left, right, label):
    """RankNet's pairwise loss; label 1 where left should rank higher."""
    diff = left - right
    return torch.log1p(torch.exp(diff)) - label * diff


def bpr_loss(logits, label):
    """Bayesian personalized ranking: mean over the negatives j of
    -log sigmoid(score[label] - score[j])."""
    lbl = label.long()[:, None]
    diff = torch.gather(logits, 1, lbl) - logits
    loss = -torch.log(torch.sigmoid(diff) + 1e-8)
    mask = torch.ones_like(loss).scatter(1, lbl, 0.0)
    return torch.sum(loss * mask, dim=1) / (logits.shape[1] - 1)


def _softplus_ce(z, t):
    """max(z, 0) - z * t + log1p(exp(-|z|))."""
    return torch.clamp(z, min=0) - z * t + \
        torch.log1p(torch.exp(-torch.abs(z)))


def teacher_student_sigmoid_loss(x, label, soft_max_up_bound: float = 15.0,
                                 soft_max_lower_bound: float = -15.0):
    """CTR distillation loss: sigmoid CE on the click for label >= -1,
    on the teacher score label + 2 (its fraction) below."""
    z = torch.clamp(x, soft_max_lower_bound, soft_max_up_bound)
    teacher = label + 2.0
    hard = _softplus_ce(z, torch.clamp(label, max=1.0))
    soft = _softplus_ce(z, teacher - torch.floor(teacher))
    return torch.where(label < -1.0, soft, hard)


def modified_huber_loss(x, y):
    """y in {0, 1} -> {-1, 1}; quadratic inside the margin, linear
    outside."""
    z = x * (2.0 * y - 1.0)
    return torch.where(z >= 1.0, torch.zeros_like(z),
                       torch.where(z >= -1.0, torch.square(1.0 - z),
                                   -4.0 * z))


def npair_loss(anchor, positive, labels, l2_reg: float = 0.002):
    """N-pair metric learning loss."""
    sim = anchor @ positive.T
    same = (labels[:, None] == labels[None, :]).to(sim.dtype)
    same = same / torch.sum(same, dim=1, keepdim=True)
    xent = -torch.sum(same * torch.log_softmax(sim, dim=1), dim=1)
    reg = l2_reg * (torch.mean(torch.sum(anchor ** 2, 1))
                    + torch.mean(torch.sum(positive ** 2, 1)))
    return torch.mean(xent) + reg


def center_loss(features, labels, centers, alpha: float = 0.5):
    """Pull features to their class centers: (loss [B], updated centers);
    repeated labels accumulate."""
    labels = labels.long()
    c = centers[labels]
    loss = 0.5 * torch.sum(torch.square(features - c), dim=1)
    k = centers.shape[0]
    counts = torch.zeros(k, dtype=torch.float32, device=centers.device
                         ).index_add_(0, labels, torch.ones(
                             labels.shape, dtype=torch.float32,
                             device=labels.device))
    delta = torch.zeros((k,) + tuple(features.shape[1:]),
                        dtype=torch.promote_types(c.dtype, features.dtype),
                        device=centers.device).index_add(
                            0, labels, c - features)
    return loss, centers - alpha * delta / (counts[:, None] + 1.0)


def mean_iou(pred, label, num_classes: int):
    """Mean intersection-over-union over the classes present (a float32
    0-d tensor); out-of-range pairs are dropped."""
    n2 = num_classes * num_classes
    pred = pred.reshape(-1).to(torch.int32).long()
    label = label.reshape(-1).to(torch.int32).long()
    idx, ones = _drop_out_of_range(label * num_classes + pred, n2,
                                   torch.ones(pred.shape, dtype=torch.float32,
                                              device=pred.device))
    cm = torch.zeros(n2, dtype=torch.float32, device=pred.device
                     ).index_add_(0, idx, ones).reshape(num_classes,
                                                         num_classes)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1.0),
                      torch.zeros_like(union))
    return torch.sum(iou) / torch.clamp(torch.sum(present), min=1)


# --------------------------------------------------------------- sampling

def sampling_id(rng: torch.Generator, probs):
    """One id per row drawn from probability rows (int64), by the
    Gumbel-max trick over log(max(p, 1e-20)) as jax.random.categorical
    draws."""
    u = torch.rand(probs.shape, generator=rng, dtype=probs.dtype,
                   device=probs.device)
    u = torch.clamp(u, min=torch.finfo(probs.dtype).tiny)
    logits = torch.log(torch.clamp(probs, min=1e-20))
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def uniform_random(rng: torch.Generator, shape, minval=-1.0, maxval=1.0,
                   dtype=torch.float32):
    """Uniform in [minval, maxval) on the generator's device."""
    u = torch.rand(tuple(shape), generator=rng, dtype=dtype,
                   device=rng.device)
    return torch.clamp(u * (maxval - minval) + minval, min=minval)


def gaussian_random(rng: torch.Generator, shape, mean=0.0, std=1.0,
                    dtype=torch.float32):
    return mean + std * torch.randn(tuple(shape), generator=rng, dtype=dtype,
                                    device=rng.device)


def truncated_gaussian_random(rng: torch.Generator, shape, mean=0.0, std=1.0,
                              dtype=torch.float32):
    """Normal truncated to 2 std, by inverting the CDF on a uniform draw
    (jax.random.truncated_normal's method)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(tuple(shape), generator=rng, dtype=dtype,
                   device=rng.device) * (hi - lo) + lo
    z = math.sqrt(2.0) * torch.erfinv(u)
    edge = float(np.nextafter(np.float32(2.0), np.float32(0.0)))
    return mean + std * torch.clamp(z, -edge, edge)


_HASH_PRIMES = (2654435761, 2246822519, 3266489917, 668265263, 374761393)
_MASK32 = 0xFFFFFFFF


def _mul32(a, p: int):
    """(a * p) mod 2^32 for a in [0, 2^32), every partial product below
    2^63."""
    lo = a * (p & 0xFFFF)
    hi = ((a * (p >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash_embedding_ids(ids, mod: int, num_hash: int = 1):
    """Map ids into [0, mod) by `num_hash` multiplicative hashes in
    wrapping uint32 arithmetic: ids [...] -> [..., num_hash] int64. The
    k-th hash adds k * 0x9E3779B9 as a uint32, so num_hash > 2 raises
    OverflowError, as JAX's does."""
    u = ids.long() & _MASK32
    h = []
    for k in range(num_hash):
        offset = k * 0x9E3779B9
        if offset > _MASK32:
            raise OverflowError(
                f"Python integer {offset} out of bounds for uint32")
        v = (_mul32(u, _HASH_PRIMES[k % len(_HASH_PRIMES)]) + offset) \
            & _MASK32
        h.append(v % mod)
    return torch.stack(h, dim=-1)


# ----------------------------------------------------------- tensor utils

def crop(x, offsets: Sequence[int], shape: Sequence[int]):
    """Static offset slice."""
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


def pad2d(x, paddings: Sequence[int], mode: str = "constant",
          value: float = 0.0):
    """NHWC spatial padding [top, bottom, left, right]; constant,
    reflect or edge."""
    t, b, l, r = paddings
    if mode == "constant":
        return F.pad(x, (0, 0, l, r, t, b), value=value)
    nchw = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b),
                 mode="reflect" if mode == "reflect" else "replicate")
    return nchw.permute(0, 2, 3, 1)


def pad_constant_like(x, y, value: float = 0.0):
    """Pad y at the end of each dim up to x's shape."""
    cfg = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        cfg += [0, xs - ys]
    return F.pad(y, cfg, value=value)


def unstack(x, axis: int = 0):
    return list(torch.unbind(x, axis))


def flatten(x, axis: int = 1):
    """Collapse the dims before and after `axis` into a matrix."""
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return x.reshape(lead, -1)


def increment(x, value: float = 1.0):
    return x + value


def fill_constant_batch_size_like(ref, shape, value, dtype=torch.float32,
                                  batch_dim: int = 0):
    """A constant of `shape` with shape[batch_dim] taken from ref, on
    ref's device."""
    shape = list(shape)
    shape[batch_dim] = ref.shape[batch_dim]
    return torch.full(shape, value, dtype=dtype, device=ref.device)


def squared_l2_norm(x):
    return torch.sum(torch.square(x))


def positive_negative_pair(scores, labels, query_ids):
    """Concordant, discordant and tied score pairs within each query:
    (pos, neg, neutral) counts."""
    same_q = query_ids[:, None] == query_ids[None, :]
    upper = torch.triu(torch.ones_like(same_q), diagonal=1)
    pair = same_q & upper & (labels[:, None] != labels[None, :])
    s_diff = scores[:, None] - scores[None, :]
    agree = (s_diff * (labels[:, None] - labels[None, :])) > 0
    tie = s_diff == 0
    pos = torch.sum(pair & agree & ~tie)
    neu = torch.sum(pair & tie)
    return pos, torch.sum(pair) - pos - neu, neu


def tree_conv(nodes, adjacency, weights, bias=None):
    """Tree-based convolution (TBCNN continuous binary tree). nodes
    [N, F]; adjacency [N, N] bool, [p, c] where c is a child of p;
    weights [F, 3, O] (top, left, right). Returns [N, O]."""
    adj = adjacency.to(torch.float32)
    nc = torch.sum(adj, dim=1, keepdim=True)
    order = torch.cumsum(adj, dim=1) * adj
    r = (order - 1.0) / torch.clamp(nc - 1.0, min=1.0) * adj
    eta_l = ((1.0 - r) * adj).to(nodes.dtype)
    eta_r = (r * adj).to(nodes.dtype)
    w_t, w_l, w_r = weights[:, 0], weights[:, 1], weights[:, 2]
    out = nodes @ w_t + (eta_l @ nodes) @ w_l + (eta_r @ nodes) @ w_r
    return out + bias if bias is not None else out
