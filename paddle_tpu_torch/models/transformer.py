"""Decoder-only CausalLM (port of paddle_tpu/models/transformer.py).

Module and parameter names mirror the JAX module tree so a JAX
`variables` tree loads by path (models/convert.py): `embed`,
`blocks.{i}` (JAX `blocks_{i}`) with `ln1`, `attn` (`q_proj`/`k_proj`/
`v_proj` or head-major fused `qkv`, then `out_proj`), `ln2`, `ffn`
(`fc1`, `fc2`), then `ln_f` and, when untied, `head`.

Two paths:

- `CausalLM.forward` — dense logits with plain causal attention, the
  oracle the tests hold the serve step against.
- `CausalLM.ragged_step_paged` — ONE mixed prefill+decode serve step
  over the flat ragged packing. The step's k/v is written into the
  per-layer block pools IN PLACE (JAX returns new pools; an in-place
  `index_copy_` saves a pool-sized copy per layer per step), then one
  `ragged_paged_attention` call per layer serves every row. The
  projections, the FFN and the tied head stay `torch.matmul`, as JAX
  left them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.kernels.attention import causal_attention
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear

Pools = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def sinusoid_position_encoding(maxlen: int, dim: int,
                               device: DeviceLike = None) -> torch.Tensor:
    """[maxlen, dim] float32: sin of pos / 10000^(2i/dim), then cos."""
    pos = torch.arange(maxlen, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


class MultiHeadAttention(nn.Module):
    """Causal self-attention; names match the JAX module.

    num_kv_heads < num_heads is grouped-query attention (k/v project to
    fewer heads). fused_qkv packs the projections into one [D, 3D]
    matmul, HEAD-MAJOR (columns ordered [head, role, head_dim], role =
    q/k/v), and requires equal head counts."""

    def __init__(self, model_dim: int, num_heads: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, fused_qkv: bool = False,
                 num_kv_heads: Optional[int] = None,
                 device: DeviceLike = None):
        super().__init__()
        if model_dim % num_heads != 0:
            raise ValueError(
                f"model_dim {model_dim} not divisible by num_heads {num_heads}")
        self.model_dim = model_dim
        self.num_heads = num_heads
        self.head_dim = model_dim // num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads != 0:
            raise ValueError(
                f"num_heads {num_heads} not a multiple of num_kv_heads "
                f"{self.num_kv_heads}")
        if fused_qkv and self.num_kv_heads != num_heads:
            raise ValueError(
                "fused_qkv packs equal-width q/k/v; use unfused "
                "projections with num_kv_heads")
        self.fused_qkv = fused_qkv
        self.dtype = dtype
        kv_dim = self.num_kv_heads * self.head_dim
        if fused_qkv:
            self.qkv = Linear(model_dim, 3 * model_dim, dtype=dtype,
                              device=device)
        else:
            self.q_proj = Linear(model_dim, model_dim, dtype=dtype,
                                 device=device)
            self.k_proj = Linear(model_dim, kv_dim, dtype=dtype, device=device)
            self.v_proj = Linear(model_dim, kv_dim, dtype=dtype, device=device)
        self.out_proj = Linear(model_dim, model_dim, dtype=dtype,
                               device=device)
        self.drop = Dropout(dropout)

    def _project(self, x: torch.Tensor):
        """x [..., D] -> q [..., H, hd], k/v [..., Hkv, hd]."""
        lead = x.shape[:-1]
        if self.fused_qkv:
            p = self.qkv(x).reshape(*lead, self.num_heads, 3, self.head_dim)
            return p[..., 0, :], p[..., 1, :], p[..., 2, :]
        return (self.q_proj(x).reshape(*lead, self.num_heads, self.head_dim),
                self.k_proj(x).reshape(*lead, self.num_kv_heads,
                                       self.head_dim),
                self.v_proj(x).reshape(*lead, self.num_kv_heads,
                                       self.head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Dense causal self-attention: x [B, T, D] -> [B, T, D]."""
        b, t = x.shape[:2]
        qh, kh, vh = self._project(x)
        out = causal_attention(qh, kh, vh)
        return self.out_proj(out.reshape(b, t, self.model_dim))

    def ragged_step_paged(self, x: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          context_lens: torch.Tensor, q_starts: torch.Tensor,
                          tile_rows: torch.Tensor, tile_offs: torch.Tensor,
                          slots: torch.Tensor) -> torch.Tensor:
        """Mixed prefill+decode step over the FLAT ragged packing: x
        [T, D]. The step's k/v is scattered into the pools at `slots`
        [T] first (in place), then one attention call serves every row.
        Returns out [T, D].

        Pad positions all scatter to scratch slot 0. With duplicate
        indices CUDA's index_copy_ keeps an arbitrary one of the
        writes; that is harmless because only the null row (ctx 1,
        all-zero table) reads scratch, and pad queries are never
        sampled."""
        t = x.shape[0]
        qh, kh, vh = self._project(x)
        nb, bs = k_pool.shape[:2]
        k_pool.view(nb * bs, *k_pool.shape[2:]).index_copy_(
            0, slots, kh.to(k_pool.dtype))
        v_pool.view(nb * bs, *v_pool.shape[2:]).index_copy_(
            0, slots, vh.to(v_pool.dtype))
        out = paged.ragged_paged_attention(
            qh.contiguous(), k_pool, v_pool, block_tables, context_lens,
            q_starts, tile_rows, tile_offs)                      # [T, H, hd]
        return self.out_proj(out.reshape(t, self.model_dim))


class FeedForward(nn.Module):
    def __init__(self, model_dim: int, hidden_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        self.fc1 = Linear(model_dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = Linear(hidden_dim, model_dim, dtype=dtype, device=device)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.drop(torch.relu(self.fc1(x))))


class CausalBlock(nn.Module):
    """Pre-LN causal self-attention + FFN block (the GPT layer shape)."""

    def __init__(self, model_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 fused_qkv: bool = False, num_kv_heads: Optional[int] = None,
                 device: DeviceLike = None):
        super().__init__()
        self.attn = MultiHeadAttention(model_dim, num_heads, dropout, dtype,
                                       fused_qkv=fused_qkv,
                                       num_kv_heads=num_kv_heads,
                                       device=device)
        self.ffn = FeedForward(model_dim, ffn_dim, dropout, dtype,
                               device=device)
        self.ln1 = LayerNorm(model_dim, device=device)
        self.ln2 = LayerNorm(model_dim, device=device)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop(self.attn(self.ln1(x)))
        return x + self.drop(self.ffn(self.ln2(x)))

    def ragged_step_paged(self, x, k_pool, v_pool, block_tables,
                          context_lens, q_starts, tile_rows, tile_offs,
                          slots) -> torch.Tensor:
        h = self.attn.ragged_step_paged(
            self.ln1(x), k_pool, v_pool, block_tables, context_lens,
            q_starts, tile_rows, tile_offs, slots)
        x = x + self.drop(h)
        return x + self.drop(self.ffn(self.ln2(x)))


class CausalLM(nn.Module):
    """Decoder-only autoregressive LM (GPT-style).

    tie_embeddings=True (default) shares the token table with the
    output head (Embedding.attend). `device` defaults to the CUDA card
    (device.resolve_device): without one, pass device="cpu"."""

    def __init__(self, vocab: int, model_dim: int = 512,
                 num_heads: int = 8, num_layers: int = 6,
                 ffn_dim: int = 2048, dropout: float = 0.1,
                 max_len: int = 2048, tie_embeddings: bool = True,
                 dtype: torch.dtype = torch.float32, fused_qkv: bool = False,
                 num_kv_heads: Optional[int] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.model_dim = model_dim
        self.max_len = max_len
        self.vocab = vocab
        self.tie_embeddings = tie_embeddings
        self.dtype = dtype
        self.embed = Embedding(vocab, model_dim, dtype=dtype, device=device)
        self.blocks = nn.ModuleList(
            CausalBlock(model_dim, num_heads, ffn_dim, dropout, dtype,
                        fused_qkv, num_kv_heads=num_kv_heads, device=device)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(model_dim, device=device)
        if not tie_embeddings:
            self.head = Linear(model_dim, vocab, dtype=dtype, device=device)
        self.drop = Dropout(dropout)
        self.register_buffer(
            "pe", sinusoid_position_encoding(max_len, model_dim, device),
            persistent=False)
        self.eval()

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return (self.embed.attend(x) if self.tie_embeddings
                else self.head(x))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] (dense, plain attention)."""
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence {t} exceeds max_len {self.max_len}")
        x = self.embed(tokens) * math.sqrt(self.model_dim)
        x = self.drop(x + self.pe[:t].to(x.dtype))
        for blk in self.blocks:
            x = blk(x)
        return self._head(self.ln_f(x))

    def ragged_step_paged(self, tokens: torch.Tensor, positions: torch.Tensor,
                          pools: Pools, block_tables: torch.Tensor,
                          context_lens: torch.Tensor, q_starts: torch.Tensor,
                          tile_rows: torch.Tensor, tile_offs: torch.Tensor,
                          slots: torch.Tensor,
                          last_idx: torch.Tensor) -> torch.Tensor:
        """ONE mixed prefill+decode serve step over the flat ragged
        packing. tokens [T] ids and positions [T] are the flat packing
        (pad positions carry token 0 at position 0 and scatter to
        scratch slot 0); per-ROW block_tables [R, MB] / context_lens [R]
        / q_starts [R] and per-TILE tile_rows / tile_offs [NT] follow
        the ragged_paged_attention contract (int32). `pools` holds each
        layer's (k_pool, v_pool), written in place. last_idx gathers hidden
        states by flat index: logits come back as last_idx.shape + (V,).
        Positions are clipped to [0, max_len): a PyTorch gather raises
        (a CUDA one reads garbage) where JAX's clamps."""
        x = self.embed(tokens.long()) * math.sqrt(self.model_dim)  # [T, D]
        pos_safe = positions.long().clamp(0, self.max_len - 1)
        x = x + self.pe[pos_safe].to(x.dtype)
        slots = slots.long()
        for blk, (k_pool, v_pool) in zip(self.blocks, pools):
            x = blk.ragged_step_paged(x, k_pool, v_pool, block_tables,
                                      context_lens, q_starts, tile_rows,
                                      tile_offs, slots)
        # LayerNorm is row-wise, so gathering the sampled rows first
        # gives the same values as normalising all T rows
        idx = last_idx.long()
        logits = self._head(self.ln_f(x[idx.reshape(-1)]))
        return logits.reshape(*idx.shape, logits.shape[-1])
