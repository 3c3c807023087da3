"""Plain attention (port of paddle_tpu/kernels/attention.py:34-84).

Layout convention: q/k/v are [B, T, H, Dh] (batch, time, heads,
head_dim), the JAX package's layout, so tests compare like with like.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def _promote_f32(x: torch.Tensor) -> torch.Tensor:
    """jnp.promote_types(dtype, float32): half types widen to float32,
    float32 and float64 stay."""
    return x.float() if x.dtype in (torch.float16, torch.bfloat16) else x


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention. q:[B,Tq,H,D] k/v:[B,Tk,Hkv,D] -> [B,Tq,H,D].

    Hkv may divide H (grouped-query / multi-query attention): the
    grouped einsum never materializes k/v repeated to H heads.

    mask: broadcastable to [B, H, Tq, Tk] (with GQA, a [B, 1|H, Tq, Tk]
    mask is regrouped to [B, Hkv, G, Tq, Tk]), True = attend. Masked
    logits are SELECTED to NEG_INF, never multiplied, so they underflow
    to exact zeros after the softmax's max shift."""
    d = q.shape[-1]
    h, h_kv = q.shape[2], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if h != h_kv:
        if h % h_kv:
            raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
        g = h // h_kv
        b, tq = q.shape[:2]
        qg = q.reshape(b, tq, h_kv, g, d)
        logits = _promote_f32(torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale)
        if mask is not None:
            m = mask
            if m.dim() == 4:  # [B, 1|H, Tq, Tk] -> group layout
                if m.shape[1] == h:
                    m = m.reshape(m.shape[0], h_kv, g, *m.shape[2:])
                else:
                    m = m[:, :, None]
            logits = torch.where(m, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return out.reshape(b, tq, h, d)
    logits = _promote_f32(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """`mha(causal=True)`'s plain path (paddle_tpu/kernels/attention.py
    :153-157): query i attends keys j <= i."""
    t_q, t_k = q.shape[1], k.shape[1]
    cmask = (torch.arange(t_k, device=q.device)[None, :]
             <= torch.arange(t_q, device=q.device)[:, None])[None, None]
    return reference_attention(q, k, v, mask=cmask)
