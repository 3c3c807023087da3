"""Ring attention: sequence / context parallelism over the mesh's "sp"
axis (port of paddle_tpu/parallel/ring.py).

JAX shards the sequence of global [B, T, H, D] arrays inside
`shard_map`; here every process is one rank of the axis, and each
function takes this rank's shard [B, T/sp, H, D] (rank r holds
positions [r T/sp, (r+1) T/sp), JAX's device shard) and returns the
rank's shard of the output. Every rank of the axis calls it, in the
same order.

- `ring_attention_inner` / `ring_attention`: the dense online-softmax
  ring (an einsum a block, as JAX's); K/V blocks rotate by `ppermute`,
  differentiable through the collectives' transposes. Pipeline stages
  use it.
- `ring_flash_attention`: kernel 4 (`kernels.flash.flash_fwd`) on each
  (q, k-block) pair, causal on the diagonal block and full elsewhere,
  merged in (o, lse) space; one autograd Function whose backward replays
  the rotation with kernels 5 and 6 (`flash_dq`, `flash_dkv`) on each
  block, given the global o and the merged lse, dk and dv travelling
  with their blocks and one last hop home. `zigzag=True` (causal only)
  takes `zigzag_shard`'s layout: each rank holds chunks (j, 2 sp-1-j)
  and does one full half-block a step besides the diagonal work.
  Unlike JAX, a block a rank cannot see under contiguous causal
  sharding (from a later rank) is skipped, not computed and masked: its
  merge weight is exp(-1e30 - m) = 0, so the merged o and lse are the
  same bits; kernel launches a rank therefore differ across the ring.
  JAX's `_divisor_block` (a Pallas tiling constraint) has no
  counterpart: the port's kernels bound-check their tails.
- `ulysses_attention`: an all_to_all regroups sequence shards into head
  shards, `flash_attention` (kernels 4-6) runs over H/sp heads on the
  whole sequence, and the reverse all_to_all follows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.parallel import collective as C

NEG_INF = -1e30


def _shift(x: torch.Tensor, axis: Optional[C.AxisGroup], sp: int):
    """One hop round the ring (rank i's x to rank i + 1)."""
    return x if axis is None else C.ppermute(x, axis, C.ring_perm(sp))


def _block_attend(q, k, v, scale, causal, q_block_idx, k_block_idx,
                  block_len):
    """Partial attention of local q [B, Tq, H, D] against one k/v block:
    (m, l [B, H, Tq, 1] float32, acc [B, Tq, H, D])."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qpos = q_block_idx * block_len + torch.arange(q.shape[1],
                                                      device=q.device)
        kpos = k_block_idx * block_len + torch.arange(k.shape[1],
                                                      device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return m, p.sum(-1, keepdim=True), acc


def ring_attention_inner(q_l, k_l, v_l, axis: Optional[C.AxisGroup],
                         sp: int, scale: Optional[float] = None,
                         causal: bool = False) -> torch.Tensor:
    """The ring body for callers already running one rank of `axis` (a
    pipeline stage): q_l/k_l/v_l are the rank's [B, T/sp, H, D] shards;
    K/V blocks rotate while online-softmax partials merge. Returns the
    rank's output shard. Differentiable."""
    d = q_l.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    my = axis.rank if axis is not None else 0
    b, tq, h, _ = q_l.shape
    m = torch.full((b, h, tq, 1), NEG_INF, device=q_l.device)
    l = torch.zeros((b, h, tq, 1), device=q_l.device)
    acc = torch.zeros_like(q_l)
    k_cur, v_cur = k_l, v_l

    def fix(c):                          # [B, H, Tq, 1] -> [B, Tq, H, 1]
        return c.transpose(1, 2).to(acc.dtype)

    for step in range(sp):
        # the block held arrived from rank (my - step) mod sp
        bm, bl, bacc = _block_attend(q_l, k_cur, v_cur, scale, causal, my,
                                     (my - step) % sp, tq)
        m_new = torch.maximum(m, bm)
        c1, c2 = torch.exp(m - m_new), torch.exp(bm - m_new)
        l = l * c1 + bl * c2
        acc = acc * fix(c1) + bacc * fix(c2)
        m = m_new
        if step != sp - 1:
            k_cur, v_cur = _shift(k_cur, axis, sp), _shift(v_cur, axis, sp)
    return (acc / fix(l.clamp_min(1e-30))).to(q_l.dtype)


def ring_attention(q, k, v, mesh, axis: str = "sp",
                   scale: Optional[float] = None,
                   causal: bool = False) -> torch.Tensor:
    """Full attention over the sequence sharded on `axis`: q/k/v are this
    rank's [B, T/sp, H, D] shards; returns its output shard."""
    return ring_attention_inner(q, k, v, mesh.maybe_group(axis),
                                mesh.shape[axis], scale, causal)


# -- ring x flash --------------------------------------------------------------

def _fwd_block(q, k, v, scale, causal):
    from paddle_tpu_torch.kernels import flash
    return flash.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                           scale=scale, causal=causal)


def _bwd_block(q, k, v, o, lse, do, scale, causal):
    """Kernels 5 and 6 on one (q, k-block) pair given the global o and
    lse: (dq, dk, dv)."""
    from paddle_tpu_torch.kernels import flash
    args = [x.contiguous() for x in (q, k, v, o, lse, do)]
    dq = flash.flash_dq(*args, scale=scale, causal=causal)
    dk, dv = flash.flash_dkv(*args, scale=scale, causal=causal)
    return dq, dk, dv


def _merge(acc_o, acc_lse, o_blk, lse_blk):
    """Combine normalised partial attentions (o [B, T, H, D] float32,
    lse [B, H, T]) with weights exp(lse - max)."""
    m = torch.maximum(acc_lse, lse_blk)
    w1, w2 = torch.exp(acc_lse - m), torch.exp(lse_blk - m)
    denom = (w1 + w2).clamp_min(1e-30)

    def bth(w):                          # [B, H, T] -> [B, T, H, 1]
        return w.transpose(1, 2)[..., None]

    new_o = (acc_o * bth(w1) + o_blk.float() * bth(w2)) / bth(denom)
    return new_o, m + torch.log(denom)


def _halves(x, dim: int = 1):
    half = x.shape[dim] // 2
    return x.narrow(dim, 0, half), x.narrow(dim, half, half)


class _RingFlash(torch.autograd.Function):
    """The ring with kernel 4 forward and kernels 5 and 6 backward
    (`ring_flash_attention`)."""

    @staticmethod
    def forward(ctx, q, k, v, axis, sp, scale, causal, zigzag):
        my = axis.rank if axis is not None else 0
        b, t_l, h, _ = q.shape

        def start(t):
            return (torch.zeros((b, t, h, q.shape[-1]), device=q.device),
                    torch.full((b, h, t), NEG_INF, device=q.device))

        k_cur, v_cur = k, v
        if zigzag:
            qa, qb = _halves(q)
            (oa, la), (ob, lb) = start(t_l // 2), start(t_l // 2)
            for step in range(sp):
                ka, kb = _halves(k_cur)
                va, vb = _halves(v_cur)
                if step == 0:
                    oa, la = _merge(oa, la, *_fwd_block(qa, ka, va, scale,
                                                        True))
                    ob, lb = _merge(ob, lb, *_fwd_block(qb, kb, vb, scale,
                                                        True))
                elif my >= step:         # the a-half sees block a
                    oa, la = _merge(oa, la, *_fwd_block(qa, ka, va, scale,
                                                        False))
                else:                    # the b-half sees block b
                    ob, lb = _merge(ob, lb, *_fwd_block(qb, kb, vb, scale,
                                                        False))
                ob, lb = _merge(ob, lb, *_fwd_block(qb, ka, va, scale,
                                                    False))
                if step != sp - 1:
                    k_cur, v_cur = (_shift(k_cur, axis, sp),
                                    _shift(v_cur, axis, sp))
            acc_o, acc_lse = torch.cat([oa, ob], 1), torch.cat([la, lb], 2)
        else:
            acc_o, acc_lse = start(t_l)
            for step in range(sp):
                # contiguous causal: the block from rank my - step is
                # visible iff my >= step (skipped otherwise: bit-equal)
                if not (causal and step > my):
                    acc_o, acc_lse = _merge(acc_o, acc_lse, *_fwd_block(
                        q, k_cur, v_cur, scale, causal and step == 0))
                if step != sp - 1:
                    k_cur, v_cur = (_shift(k_cur, axis, sp),
                                    _shift(v_cur, axis, sp))
        out = acc_o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, acc_lse)
        ctx.cfg = (axis, sp, scale, causal, zigzag, my)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        axis, sp, scale, causal, zigzag, my = ctx.cfg
        do = do.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, device=q.device)
        dk_cur = torch.zeros(k.shape, device=q.device)
        dv_cur = torch.zeros(v.shape, device=q.device)
        k_cur, v_cur = k, v
        if zigzag:
            qa, qb = _halves(q)
            oa, ob = _halves(out)
            doa, dob = _halves(do)
            la, lb = _halves(lse, 2)
            dqa, dqb = _halves(dq)
            for step in range(sp):
                ka, kb = _halves(k_cur)
                va, vb = _halves(v_cur)
                dka, dkb = _halves(dk_cur)
                dva, dvb = _halves(dv_cur)
                if step == 0:
                    todo = [(qa, ka, va, oa, la, doa, True, dqa, dka, dva),
                            (qb, kb, vb, ob, lb, dob, True, dqb, dkb, dvb)]
                elif my >= step:
                    todo = [(qa, ka, va, oa, la, doa, False, dqa, dka, dva)]
                else:
                    todo = [(qb, kb, vb, ob, lb, dob, False, dqb, dkb, dvb)]
                todo.append((qb, ka, va, ob, lb, dob, False, dqb, dka, dva))
                for (qq, kk, vv, oo, ll, dd, diag, gq, gk, gv) in todo:
                    g = _bwd_block(qq, kk, vv, oo, ll, dd, scale, diag)
                    gq += g[0]
                    gk += g[1]
                    gv += g[2]
                if step != sp - 1:
                    k_cur, v_cur, dk_cur, dv_cur = (
                        _shift(x, axis, sp)
                        for x in (k_cur, v_cur, dk_cur, dv_cur))
        else:
            for step in range(sp):
                if not (causal and step > my):
                    g = _bwd_block(q, k_cur, v_cur, out, lse, do, scale,
                                   causal and step == 0)
                    dq += g[0]
                    dk_cur += g[1]
                    dv_cur += g[2]
                if step != sp - 1:
                    k_cur, v_cur, dk_cur, dv_cur = (
                        _shift(x, axis, sp)
                        for x in (k_cur, v_cur, dk_cur, dv_cur))
        # after sp - 1 hops dk/dv sit one hop short of home
        dk_cur, dv_cur = _shift(dk_cur, axis, sp), _shift(dv_cur, axis, sp)
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None, None, None)


def ring_flash_attention(q, k, v, mesh, axis: str = "sp",
                         scale: Optional[float] = None,
                         causal: bool = False,
                         zigzag: bool = False) -> torch.Tensor:
    """Ring attention with kernels 4-6 on each block. q/k/v: this rank's
    [B, T/sp, H, D] shards (with `zigzag=True`, causal only, shards of
    `zigzag_shard`'s order; unshard the output). Differentiable."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if zigzag and not causal:
        raise ValueError("zigzag sharding only applies to causal attention")
    if zigzag and q.shape[1] % 2:
        raise ValueError(f"zigzag needs an even local length, got "
                         f"{q.shape[1]}")
    return _RingFlash.apply(q, k, v, mesh.maybe_group(axis),
                            mesh.shape[axis], float(scale), bool(causal),
                            bool(zigzag))


def _zigzag_order(sp: int) -> np.ndarray:
    order = []
    for j in range(sp):
        order.extend([j, 2 * sp - 1 - j])
    return np.asarray(order)


def _take_chunks(x: torch.Tensor, chunks, sp: int, axis: int):
    t = x.shape[axis]
    if t % (2 * sp):
        raise ValueError(f"length {t} does not split into {2 * sp} chunks")
    c = t // (2 * sp)
    idx = torch.cat([torch.arange(int(j) * c, (int(j) + 1) * c)
                     for j in chunks]).to(x.device)
    return torch.index_select(x, axis, idx)


def zigzag_shard(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    """Reorder the sequence so that contiguous rank shards hold the
    zig-zag chunk pairs (j, 2 sp - 1 - j); T % (2 sp) == 0."""
    return _take_chunks(x, _zigzag_order(sp), sp, axis)


def zigzag_unshard(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    """Inverse of zigzag_shard."""
    return _take_chunks(x, np.argsort(_zigzag_order(sp)), sp, axis)


# -- Ulysses ------------------------------------------------------------------

def ulysses_attention(q, k, v, mesh, axis: str = "sp",
                      scale: Optional[float] = None,
                      causal: bool = False) -> torch.Tensor:
    """All-to-all sequence parallelism: q/k/v are this rank's
    [B, T/sp, H, D] shards, H % sp == 0; returns the rank's output
    shard. Differentiable (the all_to_alls transpose to each other;
    `flash_attention` carries kernels 4-6)."""
    from paddle_tpu_torch.kernels.flash import flash_attention
    h = q.shape[2]
    sp = mesh.shape[axis]
    if h % sp:
        raise ValueError(f"heads {h} not divisible by sp axis {sp}")
    g = mesh.maybe_group(axis)

    def seq_to_heads(x):      # [B, T/sp, H, D] -> [B, T, H/sp, D]
        return C.all_to_all(x, g, 2, 1) if g is not None else x

    def heads_to_seq(x):
        return C.all_to_all(x, g, 1, 2) if g is not None else x

    o = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                        scale=scale, causal=causal)
    return heads_to_seq(o)


__all__ = ["ring_attention", "ring_attention_inner", "ring_flash_attention",
           "ulysses_attention", "zigzag_shard", "zigzag_unshard"]
