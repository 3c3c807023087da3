"""Attention entry points (port of paddle_tpu/kernels/attention.py).

Layout convention: q/k/v are [B, T, H, Dh] (batch, time, heads,
head_dim), the JAX package's layout, so tests compare like with like.

`mha` dispatches as JAX's does (`would_use_flash`), with "on a TPU"
read as "the tensors are on CUDA": the flash kernels (kernels/flash.py)
there, `reference_attention` with dense masks otherwise (CPU tensors,
an explicit `mask`, head dims the kernels do not take). JAX's two
length thresholds (q >= 64, k >= 512, measured on a TPU) and its
multiple-of-32 head-dim rule are dropped, so every causal call on the
card reaches the flash forward kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.kernels import flash

NEG_INF = -1e9


def _promote_f32(x: torch.Tensor) -> torch.Tensor:
    """jnp.promote_types(dtype, float32): half types widen to float32,
    float32 and float64 stay."""
    return x.float() if x.dtype in (torch.float16, torch.bfloat16) else x


def _dropout_probs(probs: torch.Tensor, rate: float,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Bernoulli dropout of the attention probabilities (upscale in
    train), drawn from `generator`; a no-op without one or at rate 0."""
    if rate <= 0.0 or generator is None:
        return probs
    keep = torch.rand(probs.shape, generator=generator,
                      device=probs.device) < 1.0 - rate
    return torch.where(keep, probs / (1.0 - rate), 0.0)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        generator: Optional[torch.Generator] = None,
                        dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain attention. q:[B,Tq,H,D] k/v:[B,Tk,Hkv,D] -> [B,Tq,H,D].

    Hkv may divide H (grouped-query / multi-query attention): the
    grouped einsum never materializes k/v repeated to H heads.

    mask: broadcastable to [B, H, Tq, Tk] (with GQA, a [B, 1|H, Tq, Tk]
    mask is regrouped to [B, Hkv, G, Tq, Tk]), True = attend. Masked
    logits are SELECTED to NEG_INF, never multiplied, so they underflow
    to exact zeros after the softmax's max shift. With `dropout_rate`
    and a `generator` the probabilities are dropped (the bits differ
    from JAX's bernoulli draw; the distribution is the same)."""
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
        probs = _dropout_probs(torch.softmax(logits, dim=-1), dropout_rate,
                               generator).to(v.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return out.reshape(b, tq, h, d)
    logits = _promote_f32(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = _dropout_probs(torch.softmax(logits, dim=-1), dropout_rate,
                           generator).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def would_use_flash(q: torch.Tensor, k: torch.Tensor,
                    has_mask: bool = False) -> bool:
    """mha's flash gate (attention.py:94-116): CUDA tensors, no dense
    mask, and a head dim the kernels take (a multiple of 8 up to 256).
    JAX's length thresholds and its head-dim rule (a multiple of 32, the
    TPU's tiling) are not carried over."""
    d = q.shape[-1]
    return (q.device.type == "cuda" and not has_mask and d % 8 == 0
            and d <= 256)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        dropout_rate: float = 0.0, causal: bool = False,
        kv_len: Optional[int] = None, segment_ids=None) -> torch.Tensor:
    """Dispatching multi-head attention (attention.py:118-164).

    `causal`, `kv_len` and `segment_ids` ([B, T] ids or a (q_seg, kv_seg)
    pair) go to the flash kernels as they are; on the reference path they
    become the dense mask `flash.visible_pairs` builds. With GQA (fewer k/v heads) k/v are repeated to H
    heads before the flash call, as `jnp.repeat` does. Dropout draws from
    `generator` (its seed on the flash path, its bernoulli bits on the
    reference path); without one there is none. An explicit `mask`
    always takes the reference path."""
    if would_use_flash(q, k, has_mask=mask is not None):
        if k.shape[2] != q.shape[2]:
            if q.shape[2] % k.shape[2]:
                raise ValueError(f"q heads {q.shape[2]} not a multiple "
                                 f"of kv heads {k.shape[2]}")
            g = q.shape[2] // k.shape[2]
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        return flash.flash_attention(q, k, v, scale=scale, causal=causal,
                                     kv_len=kv_len, segment_ids=segment_ids,
                                     dropout_rate=dropout_rate,
                                     generator=generator)
    if causal or kv_len is not None or segment_ids is not None:
        t_q, t_k = q.shape[1], k.shape[1]
        q_seg = kv_seg = None
        if segment_ids is not None:
            q_seg, kv_seg = (s.to(q.device) for s in
                             flash.normalize_segment_ids(
                                 segment_ids, q.shape[0], t_q, t_k))
        vis = flash.visible_pairs(q.shape[0], t_q, t_k, causal, kv_len,
                                  q_seg, kv_seg, q.device)
        mask = vis if mask is None else mask & vis
    return reference_attention(q, k, v, mask=mask, scale=scale,
                               generator=generator,
                               dropout_rate=dropout_rate)
