"""Ragged-sequence ops (port of paddle_tpu/ops/sequence.py), the
replacement for LoD.

A batch of variable-length sequences is either dense padded
[B, max_len, ...] with `lengths`, or packed [total, ...] with
`segment_ids`; the functions below convert between the two and run the
sequence op family (pool, softmax, expand, concat, reverse, pad/unpad,
mask, first/last step, erase, enumerate, conv, slice, scatter) on them
with masks, as the JAX package does. Shapes stay static: `maxlen` and
`num_segments` are Python ints. Ids and lengths the ops make are
int32, as JAX's are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e9


def _t(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


# --------------------------------------------------------- padded <-> packed

class Ragged(NamedTuple):
    """Packed ragged batch: rows of all sequences concatenated.

    data: [total, ...]; segment_ids: [total] int32 (row -> sequence
    index, padding rows get `num_segments`); lengths: [batch]."""
    data: torch.Tensor
    segment_ids: torch.Tensor
    lengths: torch.Tensor

    @property
    def num_segments(self) -> int:
        return self.lengths.shape[0]


def sequence_mask(lengths, maxlen: int, dtype: torch.dtype = torch.bool):
    """[B] lengths -> [B, maxlen] mask."""
    lengths = _t(lengths)
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def pack_padded(x, lengths) -> Ragged:
    """Dense [B, T, ...] + lengths -> packed Ragged with total = B*T
    rows (padding rows keep segment_id == B, so segment ops drop
    them)."""
    lengths = _t(lengths, x.device)
    b, t = x.shape[0], x.shape[1]
    mask = sequence_mask(lengths, t)
    seg = torch.where(mask, torch.arange(b, dtype=torch.int32,
                                         device=x.device)[:, None],
                      torch.full((), b, dtype=torch.int32, device=x.device))
    return Ragged(data=x.reshape(b * t, *x.shape[2:]),
                  segment_ids=seg.reshape(-1), lengths=lengths)


def pad_packed(r: Ragged, maxlen: int):
    """Packed -> dense [B, maxlen, ...] + mask."""
    b = r.num_segments
    dev = r.data.device
    seg = r.segment_ids.long()
    onehot = (seg[:, None] == torch.arange(b, device=dev)[None, :]).long()
    pos_in_seq = torch.cumsum(onehot, dim=0) - 1
    pos = torch.take_along_dim(pos_in_seq, (seg % b)[:, None], dim=1)[:, 0]
    valid = seg < b
    idx_b = torch.where(valid, seg, torch.zeros_like(seg))
    idx_t = torch.where(valid, torch.clamp(pos, max=maxlen - 1),
                        torch.zeros_like(pos))
    keep = valid.reshape(-1, *(1,) * (r.data.dim() - 1))
    upd = torch.where(keep, r.data, torch.zeros_like(r.data))
    out = torch.zeros((b, maxlen, *r.data.shape[1:]), dtype=r.data.dtype,
                      device=dev)
    out = out.index_put((idx_b, idx_t), upd, accumulate=True)
    return out, sequence_mask(r.lengths, maxlen)


# ------------------------------------------------------------- pooling/steps

def sequence_pool(x, lengths, pool_type: str = "sum"):
    """Pool over time of a padded batch [B, T, D]: sum, average, sqrt,
    max, first or last."""
    lengths = _t(lengths, x.device)
    t = x.shape[1]
    mask = sequence_mask(lengths, t, x.dtype)[..., None]
    if pool_type == "sum":
        return torch.sum(x * mask, dim=1)
    if pool_type in ("average", "mean"):
        denom = torch.clamp(lengths, min=1).to(x.dtype)[:, None]
        return torch.sum(x * mask, dim=1) / denom
    if pool_type == "sqrt":
        denom = torch.sqrt(torch.clamp(lengths, min=1).to(x.dtype))[:, None]
        return torch.sum(x * mask, dim=1) / denom
    if pool_type == "max":
        neg = torch.where(mask > 0, x, torch.full_like(x, NEG_INF))
        return torch.amax(neg, dim=1)
    if pool_type == "first":
        return x[:, 0]
    if pool_type == "last":
        idx = torch.clamp(lengths - 1, min=0).long()
        return torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0]
    raise ValueError(f"unknown pool_type {pool_type!r}")


def sequence_first_step(x, lengths):
    return sequence_pool(x, lengths, "first")


def sequence_last_step(x, lengths):
    return sequence_pool(x, lengths, "last")


def _segment_reduce(data, segment_ids, num_segments: int, how: str):
    """jax.ops.segment_sum / segment_max over the first axis: ids
    outside [0, num_segments) are dropped; an empty segment's max is
    -inf."""
    seg = segment_ids.long()
    keep = (seg >= 0) & (seg < num_segments)
    data, seg = data[keep], seg[keep]
    shape = (num_segments, *data.shape[1:])
    idx = seg.reshape(-1, *(1,) * (data.dim() - 1)).expand_as(data)
    if how == "sum":
        out = torch.zeros(shape, dtype=data.dtype, device=data.device)
        return out.scatter_add(0, idx, data)
    out = torch.full(shape, float("-inf"), dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)


def segment_pool(r: Ragged, pool_type: str = "sum"):
    """Pool a packed Ragged [total, D] -> [B, D] by segments (the packed
    counterpart of sequence_pool)."""
    b = r.num_segments
    if pool_type == "sum":
        return _segment_reduce(r.data, r.segment_ids, b + 1, "sum")[:b]
    if pool_type in ("average", "mean"):
        s = _segment_reduce(r.data, r.segment_ids, b + 1, "sum")[:b]
        return s / torch.clamp(r.lengths, min=1).to(s.dtype)[:, None]
    if pool_type == "max":
        return _segment_reduce(r.data, r.segment_ids, b + 1, "max")[:b]
    raise ValueError(f"unknown pool_type {pool_type!r}")


# ---------------------------------------------------------------- softmax

def sequence_softmax(x, lengths):
    """Masked softmax over time of [B, T] or [B, T, ...]."""
    lengths = _t(lengths, x.device)
    t = x.shape[1]
    mask = sequence_mask(lengths, t)
    m = mask.reshape(mask.shape[0], t, *(1,) * (x.dim() - 2))
    z = torch.where(m, x, torch.full_like(x, NEG_INF))
    z = z - torch.amax(z, dim=1, keepdim=True)
    e = torch.exp(z) * m.to(x.dtype)
    return e / torch.clamp(torch.sum(e, dim=1, keepdim=True), min=1e-12)


# ------------------------------------------------------- expand/concat/etc.

def sequence_expand_padded(x, ref_lengths, maxlen: int):
    """x: [B, D] -> [B, maxlen, D] with rows masked beyond ref_lengths."""
    mask = sequence_mask(_t(ref_lengths, x.device), maxlen, x.dtype)
    return x[:, None, :] * mask[..., None]


def sequence_expand_as(x, ref_lengths, maxlen: int):
    """The sequence_expand_as op: repeat row i of x ref_lengths[i] times,
    in the padded form of sequence_expand_padded."""
    return sequence_expand_padded(x, ref_lengths, maxlen)


def sequence_reshape(x, lengths, new_dim: int):
    """The sequence_reshape op: each sequence's [len_i, D] payload as
    [len_i*D/new_dim, new_dim]. Padded form: [B, T, D] ->
    [B, T*D//new_dim, new_dim] + new lengths."""
    b, t, d = x.shape
    if (t * d) % new_dim != 0:
        raise ValueError("padded payload must divide new_dim")
    new_t = t * d // new_dim
    out = x.reshape(b, new_t, new_dim)
    new_lengths = torch.div(_t(lengths, x.device) * d, new_dim,
                            rounding_mode="floor")
    mask = sequence_mask(new_lengths, new_t, x.dtype)
    return out * mask[..., None], new_lengths


def sequence_scatter(x, index, updates, updates_lengths):
    """The sequence_scatter op: per sample i, x[i, index[i, j]] +=
    updates[i, j] for j < updates_lengths[i]. x: [B, N]; index and
    updates [B, T]."""
    index = _t(index, x.device).long()
    b, t = index.shape
    mask = sequence_mask(_t(updates_lengths, x.device), t, updates.dtype)
    upd = updates * mask
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, t)
    return x.index_put((bidx, index), upd.to(x.dtype), accumulate=True)


def sequence_reverse(x, lengths):
    """Reverse each row's valid prefix of [B, T, ...]."""
    lengths = _t(lengths, x.device).long()
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    rev_idx = lengths[:, None] - 1 - pos[None, :]
    idx = torch.where(rev_idx >= 0, rev_idx, pos[None, :].expand_as(rev_idx))
    return torch.take_along_dim(
        x, idx.reshape(*idx.shape, *(1,) * (x.dim() - 2)), dim=1)


def sequence_concat(xs, lengths_list, maxlen: int):
    """Concatenate each sample's sequences from several padded batches.
    Returns padded [B, maxlen, ...] + new lengths."""
    b = xs[0].shape[0]
    dev = xs[0].device
    d_shape = xs[0].shape[2:]
    out = torch.zeros((b, maxlen, *d_shape), dtype=xs[0].dtype, device=dev)
    total = torch.zeros((b,), dtype=_t(lengths_list[0]).dtype, device=dev)
    for x, lens in zip(xs, lengths_list):
        lens = _t(lens, dev)
        t = x.shape[1]
        mask = sequence_mask(lens, t)
        tpos = total[:, None].long() + torch.arange(t, device=dev)[None, :]
        idx_t = torch.where(mask, tpos, torch.full_like(tpos, maxlen - 1))
        keep = mask.reshape(*mask.shape, *(1,) * len(d_shape))
        upd = torch.where(keep, x, torch.zeros_like(x))
        bidx = torch.arange(b, device=dev)[:, None].expand(b, t)
        out = out.index_put((bidx, idx_t), upd, accumulate=True)
        total = total + lens
    return out, total


def sequence_slice(x, lengths, offset, length):
    """Per-sequence slice: `length[i]` steps from `offset[i]` of each
    row, padded to the static bound `length` (a Python int or a 0-d
    tensor), else to T."""
    lengths = _t(lengths, x.device)
    t = x.shape[1]
    scalar = not isinstance(length, torch.Tensor) or length.dim() == 0
    max_out = int(length) if scalar else t
    starts = _t(offset, x.device).broadcast_to(lengths.shape)
    lens = _t(length, x.device).broadcast_to(lengths.shape)
    pos = torch.arange(max_out, device=x.device)
    idx = torch.clamp(starts[:, None].long() + pos[None, :], max=t - 1)
    out = torch.take_along_dim(
        x, idx.reshape(*idx.shape, *(1,) * (x.dim() - 2)), dim=1)
    return out, lens


def sequence_erase(tokens, lengths, erase_tokens):
    """Remove the given token values, left-compacting each row; returns
    new padded tokens + new lengths. tokens: [B, T]."""
    tokens = _t(tokens)
    lengths = _t(lengths, tokens.device)
    b, t = tokens.shape
    keep = sequence_mask(lengths, t)
    for e in erase_tokens:
        keep = keep & (tokens != e)
    new_len = torch.sum(keep, dim=1).to(torch.int32)
    target = torch.cumsum(keep.long(), dim=1) - 1
    tgt = torch.where(keep, target, torch.full_like(target, t - 1))
    upd = torch.where(keep, tokens, torch.zeros_like(tokens))
    flat = (torch.arange(b, device=tokens.device)[:, None] * t + tgt)
    out = torch.zeros_like(tokens).reshape(-1).scatter_reduce(
        0, flat.reshape(-1), upd.reshape(-1), "amax").reshape(b, t)
    return out * sequence_mask(new_len, t, tokens.dtype), new_len


def sequence_enumerate(tokens, lengths, win_size: int, pad_value: int = 0):
    """Sliding windows of ids: [B, T] -> [B, T, win_size]; positions
    past each row's length give pad_value."""
    tokens = _t(tokens)
    lengths = _t(lengths, tokens.device)
    t = tokens.shape[1]
    idx = (torch.arange(t, device=tokens.device)[:, None]
           + torch.arange(win_size, device=tokens.device)[None, :])
    valid = idx < lengths[:, None, None]
    wins = tokens[:, torch.clamp(idx, max=t - 1)]
    return torch.where(valid, wins, torch.full_like(wins, pad_value))


def sequence_conv(x, lengths, filter_w, context_size: int = 3,
                  context_start: Optional[int] = None):
    """Context-window convolution over time: concatenate a window of
    steps, then project. x: [B, T, D]; filter_w: [context_size*D, out].
    Windows never reach into padding (it is masked)."""
    b, t, d = x.shape
    start = -(context_size // 2) if context_start is None else context_start
    mask = sequence_mask(_t(lengths, x.device), t, x.dtype)[..., None]
    xm = x * mask
    cols = []
    for k in range(context_size):
        shift = start + k
        rolled = torch.roll(xm, -shift, dims=1)
        pos = torch.arange(t, device=x.device) + shift
        ok = ((pos >= 0) & (pos < t)).to(x.dtype)[None, :, None]
        cols.append(rolled * ok)
    ctx = torch.cat(cols, dim=-1)                    # [B, T, ctx*D]
    out = torch.einsum("btc,co->bto", ctx, filter_w)
    return out * mask


# ---------------------------------------------------------------- shrinking

def shrink_memory(state, step: int, rank_lengths):
    """DynamicRNN's memory shrink: zero the rows whose sequence ended by
    `step` (masked, so the shape stays static)."""
    alive = _t(rank_lengths, state.device) > step
    shape = (state.shape[0],) + (1,) * (state.dim() - 1)
    return state * alive.reshape(shape).to(state.dtype)
