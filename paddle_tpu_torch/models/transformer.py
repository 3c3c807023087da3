"""The transformer models (port of paddle_tpu/models/transformer.py):
the decoder-only `CausalLM`, the encoder-decoder `Transformer` and the
`BertEncoder`.

Module and parameter names mirror the JAX module tree so a JAX
`variables` tree loads by path (models/convert.py): for the CausalLM
`embed`, `blocks.{i}` (JAX `blocks_{i}`) with `ln1`, `attn` (`q_proj`/
`k_proj`/`v_proj` or head-major fused `qkv`, then `out_proj`), `ln2`,
`ffn` (`fc1`, `fc2`), then `ln_f` and, when untied, `head`. JAX makes a
parameter on its first use, so a fused attention holds only what its
role uses: `qkv` for self-attention, `q_proj` and the packed `kv` for
cross-attention; the port's `MultiHeadAttention` is told its role when
it is built (`cross=`).

The CausalLM's four paths:

- `CausalLM.forward` — the dense training forward (logits, or the
  pre-head hidden states for the fused cross-entropy), with
  `segment_ids`, `positions` and dropout drawn from the caller's
  `torch.Generator`. Attention goes through `mha`: the flash kernels
  on the card, plain causal attention on the CPU. It is also the oracle
  the tests hold the serve steps against.
- `CausalLM.ragged_step_paged` — ONE mixed prefill+decode serve step
  over the flat ragged packing (the engine's path). With the engine's
  int8 tier on, each layer's int8 pools and scales join its attention
  call, and bias-encoded table entries are read in place.
- the split path: `CausalLM.prefill_chunk_paged` (a window of each
  prompt, plain `paged_prefill_attention`) then `decode_step_paged`
  (one token per sequence through the `paged_attention` kernel).
- the dense KV-cache path: `CausalLM.prefill` (block-causal over the
  prompt: the flash forward kernel on the card) then `decode_step` (one
  token against a [B, Tmax] cache under an explicit mask, `mha`'s dense
  path), driven by `generate`; `prefill_paged` gives a right-padded
  batch's prompt k/v.

Every paged path writes the step's k/v into the per-layer block pools
IN PLACE (JAX returns new pools; an in-place `index_copy_` saves a
pool-sized copy per layer per step). The projections, the FFN and the
tied head stay `torch.matmul`, as JAX left them to XLA.

Tensor-parallel serving (`tp=`, a `ServeTP`, on the serve step and the
split path's chunked prefill): each rank's model holds its shard of the
weights (parallel/sharding.serve_tp_rules; `shard_module`) and runs at
local widths — H/tp query heads over Hkv/tp kv heads against its own
head slice of the pools, the fc1 columns of its ffn/tp features — so no
collective runs inside attention. out_proj and fc2 are row-parallel:
each rank's partial product is summed over the ranks (out_proj in fp,
fc2 by the serving collective's mode), and their biases are added once,
after the sum. Embeddings, LayerNorms and the head are whole on every
rank, so every rank's logits are complete.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from paddle_tpu_torch.core.module import ModuleError
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.kernels.attention import mha
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear
from paddle_tpu_torch.ops.sequence import sequence_mask
from paddle_tpu_torch.utils.rng import fold_in

Pools = Sequence[Tuple[torch.Tensor, torch.Tensor]]
# one layer's dense decode cache: {"k", "v"} [B, Tmax, Hkv, hd]
Cache = Dict[str, torch.Tensor]
# one layer's int8 tier: (kq_pool, vq_pool, k_scales, v_scales)
QPool = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sinusoid_position_encoding(maxlen: int, dim: int,
                               device: DeviceLike = None) -> torch.Tensor:
    """[maxlen, dim] float32: sin of pos / 10000^(2i/dim), then cos."""
    pos = torch.arange(maxlen, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def init_kv_caches(layers, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> List[Cache]:
    """Zeroed per-layer KV caches for the dense incremental decode
    (transformer.py:47): one {"k", "v"} [B, max_len, Hkv, hd] dict per
    layer of `layers` (CausalBlocks, or DecoderLayers' self-attention),
    on the layers' device. The caches take the model's compute dtype (a
    bf16 model decodes from bf16 caches) unless `dtype` overrides it."""
    first = layers[0]
    attn = getattr(first, "self_attn", None) or first.attn
    dev = attn.out_proj.weight.device
    shape = (batch, max_len, attn.num_kv_heads, attn.head_dim)
    dt = dtype if dtype is not None else attn.dtype
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in layers]


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention; names match the JAX module.

    num_kv_heads < num_heads is grouped-query attention (k/v project to
    fewer heads). fused_qkv packs the projections HEAD-MAJOR (columns
    ordered [head, role, head_dim]) and requires equal head counts: a
    self-attention holds one [D, 3D] `qkv` (role q/k/v), a
    cross-attention (`cross=True`) `q_proj` and one [D, 2D] `kv` (role
    k/v), which is what JAX makes for each role."""

    def __init__(self, model_dim: int, num_heads: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, fused_qkv: bool = False,
                 num_kv_heads: Optional[int] = None,
                 device: DeviceLike = None, cross: bool = False):
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
        if fused_qkv and cross:
            self.q_proj = Linear(model_dim, model_dim, dtype=dtype,
                                 device=device)
            self.kv = Linear(model_dim, 2 * model_dim, dtype=dtype,
                             device=device)
        elif fused_qkv:
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

    def _project_cross(self, x: torch.Tensor, kv: torch.Tensor):
        """q [..., Tq, H, hd] from x, k/v [..., Tk, Hkv, hd] from kv."""
        qh = self.q_proj(x).reshape(*x.shape[:-1], self.num_heads,
                                    self.head_dim)
        lead = kv.shape[:-1]
        if self.fused_qkv:
            p = self.kv(kv).reshape(*lead, self.num_heads, 2, self.head_dim)
            return qh, p[..., 0, :], p[..., 1, :]
        return (qh,
                self.k_proj(kv).reshape(*lead, self.num_kv_heads,
                                        self.head_dim),
                self.v_proj(kv).reshape(*lead, self.num_kv_heads,
                                        self.head_dim))

    def _project(self, x: torch.Tensor, tp=None):
        """x [..., D] -> q [..., H, hd], k/v [..., Hkv, hd]; under `tp`
        this rank's H/tp and Hkv/tp heads (a head-major fused qkv keeps
        whole heads in each rank's column block)."""
        lead = x.shape[:-1]
        n = tp.size if tp is not None else 1
        h, hkv = self.num_heads // n, self.num_kv_heads // n
        if self.fused_qkv:
            p = self.qkv(x).reshape(*lead, h, 3, self.head_dim)
            return p[..., 0, :], p[..., 1, :], p[..., 2, :]
        return (self.q_proj(x).reshape(*lead, h, self.head_dim),
                self.k_proj(x).reshape(*lead, hkv, self.head_dim),
                self.v_proj(x).reshape(*lead, hkv, self.head_dim))

    def _out(self, out: torch.Tensor, tp=None) -> torch.Tensor:
        """out_proj over the heads' output [..., heads * hd]: under `tp`
        row-parallel over this rank's heads, the partial products summed
        over the ranks in fp (JAX's GSPMD psum in both modes), the bias
        added after the sum."""
        if tp is None:
            return self.out_proj(out)
        from paddle_tpu_torch.parallel.collective import all_reduce
        lin = self.out_proj
        y = all_reduce(torch.matmul(out.to(lin.dtype),
                                    lin.weight.to(lin.dtype)), tp.group)
        return y if lin.bias is None else y + lin.bias.to(lin.dtype)

    def forward(self, x: torch.Tensor, segment_ids=None,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None, causal: bool = True,
                cache: Optional[Cache] = None, decode_pos: int = 0,
                prefill: bool = False, kv: Optional[torch.Tensor] = None):
        """Attention (transformer.py:129-184): x [B, T, D] -> [B, T, D],
        over x itself, or with `kv` [B, Tk, D] cross-attention over kv
        (a `cross=True` module). segment_ids [B, T] keeps attention
        inside each packed document; `mask` (broadcastable to
        [B, H, T, Tk], True = attend) is an explicit pattern, which takes
        `mha`'s dense path; in training, attention dropout at this
        layer's rate draws from `generator`. `causal` defaults to True
        here, where JAX's default is False; every layer passes it.

        With `cache` ({"k", "v"} [B, Tmax, Hkv, hd]) this call's k/v are
        written at `decode_pos` into a NEW cache (the given one is left
        as it is, as JAX's dynamic_update_slice leaves it; the start is
        clamped so the window fits, as JAX clamps it) and the call
        returns (out, new cache). `prefill=True` attends over this
        call's k/v only (the caller passes causal=True: on the card that
        is the flash forward kernel); otherwise the query attends over
        the whole new cache under `mask`."""
        b, t = x.shape[:2]
        qh, kh, vh = (self._project(x) if kv is None
                      else self._project_cross(x, kv))
        if cache is not None:
            tmax = cache["k"].shape[1]
            start = min(max(int(decode_pos), 0), tmax - t)
            idx = torch.arange(start, start + t, device=x.device)
            cache = {"k": cache["k"].index_copy(1, idx,
                                                kh.to(cache["k"].dtype)),
                     "v": cache["v"].index_copy(1, idx,
                                                vh.to(cache["v"].dtype))}
            if not prefill:
                kh, vh = cache["k"], cache["v"]
        drop = self.training and self.drop.rate > 0
        out = mha(qh, kh, vh, mask=mask, causal=causal,
                  segment_ids=segment_ids,
                  generator=generator if drop else None,
                  dropout_rate=self.drop.rate if self.training else 0.0)
        out = self.out_proj(out.reshape(b, t, self.model_dim))
        return out if cache is None else (out, cache)

    @staticmethod
    def _scatter(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 kh: torch.Tensor, vh: torch.Tensor,
                 slots: torch.Tensor) -> None:
        """Write k/v rows [N, Hkv, hd] into the pools' flat slots [N],
        in place. Pad positions all scatter to scratch slot 0: with
        duplicate indices CUDA's index_copy_ keeps an arbitrary one of
        the writes, which is harmless because only the null row (ctx 1,
        all-zero table) reads scratch and pad queries are never
        sampled."""
        nb, bs = k_pool.shape[:2]
        k_pool.view(nb * bs, *k_pool.shape[2:]).index_copy_(
            0, slots, kh.to(k_pool.dtype))
        v_pool.view(nb * bs, *v_pool.shape[2:]).index_copy_(
            0, slots, vh.to(v_pool.dtype))

    def ragged_step_paged(self, x: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          context_lens: torch.Tensor, q_starts: torch.Tensor,
                          tile_rows: torch.Tensor, tile_offs: torch.Tensor,
                          slots: torch.Tensor,
                          qpool: Optional[QPool] = None,
                          tp=None) -> torch.Tensor:
        """Mixed prefill+decode step over the FLAT ragged packing: x
        [T, D]. The step's k/v is scattered into the pools at `slots`
        [T] first (in place), then one attention call serves every row.
        `qpool` = (kq, vq, k_scales, v_scales) threads this layer's int8
        tier into the call: bias-encoded (negative) table entries read
        it in place. Writes always target the fp pool. Under `tp` the
        pools are this rank's head slices and attention runs at its
        local heads. Returns out [T, D]."""
        t = x.shape[0]
        qh, kh, vh = self._project(x, tp)
        self._scatter(k_pool, v_pool, kh, vh, slots)
        kq, vq, ksc, vsc = qpool if qpool is not None else (None,) * 4
        args = (qh.contiguous(), k_pool, v_pool, block_tables, context_lens,
                q_starts, tile_rows, tile_offs)
        quant = dict(kq_pool=kq, vq_pool=vq, k_scales=ksc, v_scales=vsc)
        out = (paged.ragged_paged_attention(*args, **quant) if tp is None
               else paged.ragged_paged_attention_tp(tp, *args, **quant))
        return self._out(out.reshape(t, -1), tp)                  # [T, D]

    def decode_paged(self, x: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     context_lens: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
        """Single-token decode through the paged cache: x [B, 1, D];
        block_tables [B, MB]; context_lens [B] valid tokens INCLUDING
        this one; slots [B] flat pool slots receiving this token's k/v
        (written into the pools in place, where JAX returns new pools).
        Returns out [B, 1, D]."""
        b = x.shape[0]
        qh, kh, vh = self._project(x)                    # [B, 1, H|Hkv, hd]
        self._scatter(k_pool, v_pool, kh[:, 0], vh[:, 0], slots)
        out = paged.paged_attention(qh[:, 0].contiguous(), k_pool, v_pool,
                                    block_tables, context_lens)  # [B, H, hd]
        return self.out_proj(out.reshape(b, 1, self.model_dim))

    def prefill_chunk_paged(self, x: torch.Tensor, q_positions: torch.Tensor,
                            k_pool: torch.Tensor, v_pool: torch.Tensor,
                            block_tables: torch.Tensor,
                            context_lens: torch.Tensor,
                            slots: torch.Tensor, tp=None) -> torch.Tensor:
        """Chunked prefill through the paged cache: x [B, C, D], a window
        of each prompt at absolute q_positions [B, C]; slots [B*C]
        receive the chunk's k/v first (in place), then every chunk query
        attends causally over the cached prefix and the chunk (under
        `tp` at this rank's heads). Returns out [B, C, D]."""
        b, c = x.shape[:2]
        qh, kh, vh = self._project(x, tp)
        self._scatter(k_pool, v_pool, kh.reshape(-1, *kh.shape[2:]),
                      vh.reshape(-1, *vh.shape[2:]), slots)
        args = (qh, k_pool, v_pool, block_tables, context_lens, q_positions)
        out = (paged.paged_prefill_attention(*args) if tp is None
               else paged.paged_prefill_attention_tp(tp, *args))
        return self._out(out.reshape(b, c, -1), tp)


class FeedForward(nn.Module):
    def __init__(self, model_dim: int, hidden_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        self.fc1 = Linear(model_dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = Linear(hidden_dim, model_dim, dtype=dtype, device=device)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.fc2(self.drop(torch.relu(self.fc1(x)), generator))

    def forward_serve_tp(self, x: torch.Tensor, tp) -> torch.Tensor:
        """Megatron column-then-row MLP of the tensor-parallel serve
        step: fc1 over this rank's columns (its bias sharded with them,
        no collective), then fc2 row-parallel over those features, whose
        one reduce takes the serving collective's mode (int8 by default,
        `PTPU_SERVE_ALLREDUCE=fp` for the exact sum). fc2's bias is added
        after the reduce."""
        from paddle_tpu_torch.parallel.serve_collective import \
            row_parallel_matmul
        h = self.drop(torch.relu(self.fc1(x)))
        fc2 = self.fc2
        y = row_parallel_matmul(h.to(fc2.dtype), fc2.weight.to(fc2.dtype),
                                tp)
        return y if fc2.bias is None else y + fc2.bias.to(fc2.dtype)


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

    def forward(self, x: torch.Tensor, segment_ids=None,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, decode_pos: int = 0,
                prefill: bool = False):
        """x [B, T, D] -> [B, T, D], or (x, new cache) with `cache`
        (transformer.py:551). Training and prefill attend block-causally
        over this call's k/v; a decode step's `mask` carries the <= pos
        constraint over the cache."""
        h = self.attn(self.ln1(x), segment_ids=segment_ids,
                      generator=generator, mask=mask,
                      causal=cache is None or prefill, cache=cache,
                      decode_pos=decode_pos, prefill=prefill)
        if cache is None:
            return self._ffn_residual(x, h, generator)
        h, cache = h
        return self._ffn_residual(x, h, generator), cache

    def _ffn_residual(self, x: torch.Tensor, h: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      tp=None) -> torch.Tensor:
        x = x + self.drop(h, generator)
        f = (self.ffn(self.ln2(x), generator) if tp is None
             else self.ffn.forward_serve_tp(self.ln2(x), tp))
        return x + self.drop(f, generator)

    def ragged_step_paged(self, x, k_pool, v_pool, block_tables,
                          context_lens, q_starts, tile_rows, tile_offs,
                          slots, qpool: Optional[QPool] = None, tp=None
                          ) -> torch.Tensor:
        return self._ffn_residual(x, self.attn.ragged_step_paged(
            self.ln1(x), k_pool, v_pool, block_tables, context_lens,
            q_starts, tile_rows, tile_offs, slots, qpool=qpool, tp=tp),
            tp=tp)

    def decode_paged(self, x, k_pool, v_pool, block_tables, context_lens,
                     slots) -> torch.Tensor:
        return self._ffn_residual(x, self.attn.decode_paged(
            self.ln1(x), k_pool, v_pool, block_tables, context_lens, slots))

    def prefill_chunk_paged(self, x, q_positions, k_pool, v_pool,
                            block_tables, context_lens, slots,
                            tp=None) -> torch.Tensor:
        return self._ffn_residual(x, self.attn.prefill_chunk_paged(
            self.ln1(x), q_positions, k_pool, v_pool, block_tables,
            context_lens, slots, tp=tp), tp=tp)


class CausalLM(nn.Module):
    """Decoder-only autoregressive LM (GPT-style).

    tie_embeddings=True (default) shares the token table with the
    output head (Embedding.attend). `device` defaults to the CUDA card
    (device.resolve_device): without one, pass device="cpu". The model
    starts in eval mode; `Trainer` switches it to training for a step."""

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

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False,
                segment_ids=None, positions: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V], or the pre-head hidden
        states [B, T, D] with `return_hidden` (feed
        ops.fused_ce.linear_cross_entropy with `head_weights()`).

        segment_ids [B, T]: packed documents; attention never crosses a
        boundary. Pair it with `positions` [B, T] (position within each
        document) so the encoding restarts per document; the default is
        0..T-1. Positions index the encoding as JAX's gather does
        (transformer.py:664): a negative one counts from the end, and
        the result is clamped to [0, max_len). In training, every
        dropout draws from `generator`."""
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence {t} exceeds max_len {self.max_len}")
        x = self.embed(tokens.long()) * math.sqrt(self.model_dim)
        if positions is None:
            pe = self.pe[:t]
        else:
            positions = positions.long()
            pe = self.pe[self._clip(torch.where(
                positions < 0, positions + self.max_len, positions))]
        x = self.drop(x + pe.to(x.dtype), generator)
        for blk in self.blocks:
            x = blk(x, segment_ids=segment_ids, generator=generator)
        x = self.ln_f(x)
        return x if return_hidden else self._head(x)

    def head_weights(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """([D, V] weight, bias or None) for linear_cross_entropy: the
        tied table transposed, or the untied head's parameters
        (transformer.py:676). Live parameters, so gradients flow."""
        if self.tie_embeddings:
            return self.embed.weight.t(), None
        return self.head.weight, self.head.bias

    # -- dense incremental decode (transformer.py:685-880) ----------------
    def init_cache(self, batch: int,
                   max_len: Optional[int] = None) -> List[Cache]:
        return init_kv_caches(self.blocks, batch, max_len or self.max_len)

    def _prefill_pass(self, tokens: torch.Tensor, caches: Sequence[Cache]
                      ) -> Tuple[torch.Tensor, List[Cache]]:
        """Hidden states [B, T0, D] before `ln_f`, and the caches with
        positions [0, T0) written: one parallel pass, each layer's
        attention block-causal over this call's k/v."""
        t0 = tokens.shape[1]
        x = self.embed(tokens.long()) * math.sqrt(self.model_dim)
        x = x + self.pe[:t0].to(x.dtype)[None]
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, nc = blk(x, cache=cache, decode_pos=0, prefill=True)
            new_caches.append(nc)
        return x, new_caches

    def prefill(self, tokens: torch.Tensor, caches: Sequence[Cache]
                ) -> Tuple[torch.Tensor, List[Cache]]:
        """ONE parallel pass over a [B, T0] prompt that writes k/v for
        positions [0, T0) into new caches and returns the last position's
        logits [B, V] (transformer.py:688). Attention is block-causal
        over the T0 k/v: the flash forward kernel on the card, never a
        dense mask over the whole cache."""
        x, new_caches = self._prefill_pass(tokens, caches)
        return self._head(self.ln_f(x[:, -1])), new_caches

    def prefill_paged(self, tokens: torch.Tensor, last_pos: torch.Tensor
                      ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor,
                                                          torch.Tensor]]]:
        """Paged-serving prefill (transformer.py:706): tokens [B, Tpad]
        right-padded prompts (causal attention keeps the padding out of
        every real position), last_pos [B] the index of each prompt's
        last real token. Returns (logits [B, V] at last_pos, each
        layer's (k, v) [B, Tpad, Hkv, hd] in the cache dtype)."""
        b, t0 = tokens.shape
        x, caches = self._prefill_pass(
            tokens, init_kv_caches(self.blocks, b, t0))
        # LayerNorm is row-wise: gathering the last rows first gives the
        # values of normalising every row
        last_h = x[torch.arange(b, device=x.device), last_pos.long()]
        return (self._head(self.ln_f(last_h)),
                [(c["k"], c["v"]) for c in caches])

    def decode_step(self, token: torch.Tensor, pos: int,
                    caches: Sequence[Cache]
                    ) -> Tuple[torch.Tensor, List[Cache]]:
        """One step (transformer.py:830): token [B] ids at position `pos`
        -> (logits [B, V], new caches). The query attends over the whole
        cache under the mask arange(Tmax) <= pos, which takes `mha`'s
        dense path (as JAX's decode did on the TPU). The encoding row and
        the cache write are clamped to their ranges, as JAX's
        dynamic_slice and dynamic_update_slice clamp them."""
        pos = int(pos)
        x = self.embed(token.long()[:, None]) * math.sqrt(self.model_dim)
        x = x + self.pe[min(max(pos, 0), self.max_len - 1)].to(x.dtype)
        tmax = caches[0]["k"].shape[1]
        smask = (torch.arange(tmax, device=x.device) <= pos)[None, None,
                                                              None]
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, nc = blk(x, mask=smask, cache=cache, decode_pos=pos)
            new_caches.append(nc)
        return self._head(self.ln_f(x))[:, 0], new_caches

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, num_steps: int,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0) -> torch.Tensor:
        """KV-cached continuation (transformer.py:846): [B, T0] prompt ->
        [B, T0 + num_steps] int64 on the model's device. One `prefill`
        pass fills the caches, then one `decode_step` a token, in eval
        mode. Greedy at temperature 0; otherwise each token is drawn
        from softmax(logits / temperature) by a generator seeded from
        (`generator`'s seed, the position of the query), as JAX folds the
        position into its key: the same seed gives the same tokens."""
        b, t0 = prompt.shape
        if t0 < 1:
            raise ValueError("generate needs a non-empty prompt")
        total = t0 + num_steps
        if total > self.max_len:
            raise ValueError(f"prompt {t0} + steps {num_steps} exceeds "
                             f"max_len {self.max_len}")
        if temperature > 0.0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs a generator")
        prompt = prompt.to(self.device, torch.long)
        if num_steps == 0:
            return prompt

        def sample(logits: torch.Tensor, i: int) -> torch.Tensor:
            # i = the position of the query that produced these logits
            if temperature > 0.0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                return torch.multinomial(
                    probs, 1, generator=fold_in(generator.initial_seed(), i,
                                                logits.device))[:, 0]
            return torch.argmax(logits, dim=-1)

        was_training = self.training
        self.eval()
        try:
            logits, caches = self.prefill(prompt, self.init_cache(b, total))
            tokens = torch.zeros((b, total), dtype=torch.long,
                                 device=self.device)
            tokens[:, :t0] = prompt
            tokens[:, t0] = sample(logits, t0 - 1)
            for i in range(t0, total - 1):
                logits, caches = self.decode_step(tokens[:, i], i, caches)
                tokens[:, i + 1] = sample(logits, i)
        finally:
            self.train(was_training)
        return tokens

    def ragged_step_paged(self, tokens: torch.Tensor, positions: torch.Tensor,
                          pools: Pools, block_tables: torch.Tensor,
                          context_lens: torch.Tensor, q_starts: torch.Tensor,
                          tile_rows: torch.Tensor, tile_offs: torch.Tensor,
                          slots: torch.Tensor,
                          last_idx: torch.Tensor,
                          qpools: Pools = (), qscales: Pools = (),
                          tp=None) -> torch.Tensor:
        """ONE mixed prefill+decode serve step over the flat ragged
        packing. tokens [T] ids and positions [T] are the flat packing
        (pad positions carry token 0 at position 0 and scatter to
        scratch slot 0); per-ROW block_tables [R, MB] / context_lens [R]
        / q_starts [R] and per-TILE tile_rows / tile_offs [NT] follow
        the ragged_paged_attention contract (int32). `pools` holds each
        layer's (k_pool, v_pool), written in place. last_idx gathers hidden
        states by flat index: logits come back as last_idx.shape + (V,).
        Positions are clipped to [0, max_len): a PyTorch gather raises
        (a CUDA one reads garbage) where JAX's clamps. With `qpools`
        (per layer (kq, vq)) and `qscales` (per layer (k, v) scales) —
        the engine's int8 tier; empty when it is off — every layer's
        attention call takes its int8 pools, so the call has one shape
        whether a batch is fp-only, mixed or all-int8. `tp` (a ServeTP)
        runs this rank's shard: the model holds its shard of the weights
        and the pools are its head slices."""
        x = self.embed(tokens.long()) * math.sqrt(self.model_dim)  # [T, D]
        x = x + self.pe[self._clip(positions)].to(x.dtype)
        slots = slots.long()
        for li, (blk, (k_pool, v_pool)) in enumerate(zip(self.blocks, pools)):
            qpool = (*qpools[li], *qscales[li]) if qpools else None
            x = blk.ragged_step_paged(x, k_pool, v_pool, block_tables,
                                      context_lens, q_starts, tile_rows,
                                      tile_offs, slots, qpool=qpool, tp=tp)
        # LayerNorm is row-wise, so gathering the sampled rows first
        # gives the same values as normalising all T rows
        idx = last_idx.long()
        logits = self._head(self.ln_f(x[idx.reshape(-1)]))
        return logits.reshape(*idx.shape, logits.shape[-1])

    def _clip(self, positions: torch.Tensor) -> torch.Tensor:
        """Positions clipped to [0, max_len) for the encoding gather, as
        JAX's clamping gather and its serve paths' explicit clips do."""
        return positions.long().clamp(0, self.max_len - 1)

    def prefill_chunk_paged(self, tokens: torch.Tensor,
                            start_pos: torch.Tensor, pools: Pools,
                            block_tables: torch.Tensor,
                            context_lens: torch.Tensor, slots: torch.Tensor,
                            last_idx: torch.Tensor, tp=None) -> torch.Tensor:
        """Chunked/suffix-only prefill of the split path: tokens [B, C]
        is ONE window of each prompt (right-padded; pad positions
        scatter to scratch slot 0), start_pos [B] the absolute position
        of each row's first window token. k/v lands in the pools in
        place (JAX returns new pools); attention runs causally through
        the pools (cached prefix + this chunk), under `tp` at this
        rank's shard. Returns logits [B, V] at each row's within-chunk
        `last_idx`."""
        b, c = tokens.shape
        x = self.embed(tokens.long()) * math.sqrt(self.model_dim)
        pos = (start_pos.long()[:, None]
               + torch.arange(c, device=tokens.device)[None, :])  # [B, C]
        x = x + self.pe[self._clip(pos)].to(x.dtype)
        slots = slots.long()
        for blk, (k_pool, v_pool) in zip(self.blocks, pools):
            x = blk.prefill_chunk_paged(x, pos, k_pool, v_pool, block_tables,
                                        context_lens, slots, tp=tp)
        hidden = self.ln_f(x)
        last_h = hidden[torch.arange(b, device=tokens.device),
                        last_idx.long()]
        return self._head(last_h)

    def decode_step_paged(self, tokens: torch.Tensor,
                          positions: torch.Tensor, pools: Pools,
                          block_tables: torch.Tensor,
                          context_lens: torch.Tensor,
                          slots: torch.Tensor) -> torch.Tensor:
        """Continuous-batching decode step of the split path: tokens [B]
        at per-sequence positions [B] (rows decode at different
        depths), block_tables [B, MB], context_lens [B] (= positions +
        1), slots [B] flat pool slots for this token's k/v (written in
        place, where JAX returns new pools). One `paged_attention`
        kernel call per layer. Returns logits [B, V]."""
        x = self.embed(tokens.long()[:, None]) * math.sqrt(self.model_dim)
        x = x + self.pe[self._clip(positions)].to(x.dtype)[:, None]
        slots = slots.long()
        for blk, (k_pool, v_pool) in zip(self.blocks, pools):
            x = blk.decode_paged(x, k_pool, v_pool, block_tables,
                                 context_lens, slots)
        return self._head(self.ln_f(x))[:, 0]


# -- the encoder-decoder Transformer and BERT (transformer.py:359-533, 901) --

class EncoderLayer(nn.Module):
    """Pre-LN bidirectional self-attention + FFN block."""

    def __init__(self, model_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 fused_qkv: bool = False, device: DeviceLike = None):
        super().__init__()
        self.attn = MultiHeadAttention(model_dim, num_heads, dropout, dtype,
                                       fused_qkv=fused_qkv, device=device)
        self.ffn = FeedForward(model_dim, ffn_dim, dropout, dtype,
                               device=device)
        self.ln1 = LayerNorm(model_dim, device=device)
        self.ln2 = LayerNorm(model_dim, device=device)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                segment_ids=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.attn(self.ln1(x), mask=mask, causal=False,
                      segment_ids=segment_ids, generator=generator)
        x = x + self.drop(h, generator)
        return x + self.drop(self.ffn(self.ln2(x), generator), generator)


class DecoderLayer(nn.Module):
    """Pre-LN causal self-attention, cross-attention over the encoder's
    memory, then the FFN."""

    def __init__(self, model_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 fused_qkv: bool = False, device: DeviceLike = None):
        super().__init__()
        self.self_attn = MultiHeadAttention(model_dim, num_heads, dropout,
                                            dtype, fused_qkv=fused_qkv,
                                            device=device)
        self.cross_attn = MultiHeadAttention(model_dim, num_heads, dropout,
                                             dtype, fused_qkv=fused_qkv,
                                             device=device, cross=True)
        self.ffn = FeedForward(model_dim, ffn_dim, dropout, dtype,
                               device=device)
        self.ln1 = LayerNorm(model_dim, device=device)
        self.ln2 = LayerNorm(model_dim, device=device)
        self.ln3 = LayerNorm(model_dim, device=device)
        self.drop = Dropout(dropout)

    def _cross_ffn(self, x: torch.Tensor, memory: torch.Tensor,
                   cross_mask: Optional[torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        h = self.cross_attn(self.ln2(x), kv=memory, mask=cross_mask,
                            causal=False, generator=generator)
        x = x + self.drop(h, generator)
        return x + self.drop(self.ffn(self.ln3(x), generator), generator)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                self_mask: Optional[torch.Tensor] = None,
                self_causal: bool = False,
                cross_mask: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, decode_pos: int = 0,
                generator: Optional[torch.Generator] = None):
        """x [B, T, D] -> (x, new cache or None). With `cache` this
        call's k/v are written at `decode_pos` and the queries attend
        over the whole new cache under `self_mask` (transformer.py:392)."""
        h = self.self_attn(self.ln1(x), mask=self_mask, causal=self_causal,
                           cache=cache, decode_pos=decode_pos,
                           generator=generator)
        new_cache = None
        if cache is not None:
            h, new_cache = h
        x = x + self.drop(h, generator)
        return self._cross_ffn(x, memory, cross_mask, generator), new_cache

    def decode_paged(self, x: torch.Tensor, memory: torch.Tensor,
                     k_pool: torch.Tensor, v_pool: torch.Tensor,
                     block_tables: torch.Tensor, context_lens: torch.Tensor,
                     slots: torch.Tensor,
                     cross_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Paged self-attention decode step (the `paged_attention`
        kernel; the pools are written in place) and dense
        cross-attention over `memory` (transformer.py:407)."""
        h = self.self_attn.decode_paged(self.ln1(x), k_pool, v_pool,
                                        block_tables, context_lens, slots)
        return self._cross_ffn(x + self.drop(h), memory, cross_mask)


class Transformer(nn.Module):
    """Encoder-decoder Transformer-base (d 512, h 8, L 6, ffn 2048).

    tie_embeddings=True shares one table between source and target
    (`src_embed`, registered first, so `named_parameters` yields it
    once under that name, the path JAX gives it). `device` defaults to
    the CUDA card. The model starts in eval mode."""

    def __init__(self, src_vocab: int, trg_vocab: int, model_dim: int = 512,
                 num_heads: int = 8, num_layers: int = 6, ffn_dim: int = 2048,
                 dropout: float = 0.1, max_len: int = 1024,
                 tie_embeddings: bool = False,
                 dtype: torch.dtype = torch.float32, fused_qkv: bool = False,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.model_dim = model_dim
        self.max_len = max_len
        self.dtype = dtype
        self.tie_embeddings = tie_embeddings
        self.src_embed = Embedding(src_vocab, model_dim, dtype=dtype,
                                   device=device)
        self.trg_embed = (self.src_embed if tie_embeddings else
                          Embedding(trg_vocab, model_dim, dtype=dtype,
                                    device=device))
        self.enc_layers = nn.ModuleList(
            EncoderLayer(model_dim, num_heads, ffn_dim, dropout, dtype,
                         fused_qkv, device=device)
            for _ in range(num_layers))
        self.dec_layers = nn.ModuleList(
            DecoderLayer(model_dim, num_heads, ffn_dim, dropout, dtype,
                         fused_qkv, device=device)
            for _ in range(num_layers))
        self.enc_ln = LayerNorm(model_dim, device=device)
        self.dec_ln = LayerNorm(model_dim, device=device)
        self.head = Linear(model_dim, trg_vocab, dtype=dtype, device=device)
        self.drop = Dropout(dropout)
        self.register_buffer(
            "pe", sinusoid_position_encoding(max_len, model_dim, device),
            persistent=False)
        self.eval()

    def _pe(self, t: int) -> torch.Tensor:
        """The encoding's first t rows (JAX computes it at length t, which
        may pass max_len in the parallel passes)."""
        if t <= self.max_len:
            return self.pe[:t]
        return sinusoid_position_encoding(t, self.model_dim, self.pe.device)

    def _embed(self, table: Embedding, tokens: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        t = tokens.shape[1]
        x = table(tokens.long()) * math.sqrt(self.model_dim)
        return self.drop(x + self._pe(t).to(x.dtype), generator)

    def encode(self, src_tokens: torch.Tensor,
               src_lengths: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(memory [B, Ts, D], src_mask [B, 1, 1, Ts] or None). With
        `src_lengths` the encoder's self-attention takes the padding as
        segment ids (real 1, pad 0: the flash kernels mask it
        block-wise) and the cross-attention gets the dense mask."""
        t = src_tokens.shape[1]
        x = self._embed(self.src_embed, src_tokens, generator)
        mask = segs = None
        if src_lengths is not None:
            valid = sequence_mask(src_lengths.to(x.device), t)
            mask = valid[:, None, None, :]
            segs = valid.to(torch.int32)
        for layer in self.enc_layers:
            x = layer(x, segment_ids=segs, generator=generator)
        return self.enc_ln(x), mask

    def decode_train(self, trg_tokens: torch.Tensor, memory: torch.Tensor,
                     src_mask: Optional[torch.Tensor] = None,
                     return_hidden: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Teacher-forced decoder: logits [B, Tt, V], or with
        `return_hidden` the pre-head hidden states [B, Tt, D] (for the
        fused cross-entropy over `head`'s weights)."""
        x = self._embed(self.trg_embed, trg_tokens, generator)
        for layer in self.dec_layers:
            x, _ = layer(x, memory, self_causal=True, cross_mask=src_mask,
                         generator=generator)
        x = self.dec_ln(x)
        return x if return_hidden else self.head(x)

    def forward(self, src_tokens: torch.Tensor, trg_tokens: torch.Tensor,
                src_lengths: Optional[torch.Tensor] = None,
                return_hidden: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        memory, src_mask = self.encode(src_tokens, src_lengths, generator)
        return self.decode_train(trg_tokens, memory, src_mask,
                                 return_hidden=return_hidden,
                                 generator=generator)

    # -- incremental decode (for beam search) ------------------------------
    def init_cache(self, batch: int,
                   max_len: Optional[int] = None) -> List[Cache]:
        return init_kv_caches(self.dec_layers, batch, max_len or self.max_len)

    def decode_step(self, token: torch.Tensor, pos: int,
                    memory: torch.Tensor, caches: Sequence[Cache],
                    src_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, List[Cache]]:
        """One step: token [B] ids at position `pos` -> (logits [B, V],
        new caches). The query attends over the cache under the mask
        arange(Tmax) <= pos (`mha`'s dense path). The encoding row and
        the cache write are clamped to their ranges, as JAX's
        dynamic_slice and dynamic_update_slice clamp them."""
        pos = int(pos)
        x = self.trg_embed(token.long()[:, None]) * math.sqrt(self.model_dim)
        x = x + self.pe[min(max(pos, 0), self.max_len - 1)].to(x.dtype)
        tmax = caches[0]["k"].shape[1]
        smask = (torch.arange(tmax, device=x.device) <= pos)[None, None,
                                                              None]
        new_caches = []
        for layer, cache in zip(self.dec_layers, caches):
            x, nc = layer(x, memory, self_mask=smask, cross_mask=src_mask,
                          cache=cache, decode_pos=pos)
            new_caches.append(nc)
        return self.head(self.dec_ln(x))[:, 0], new_caches

    def decode_step_paged(self, token: torch.Tensor, positions: torch.Tensor,
                          memory: torch.Tensor, pools: Pools,
                          block_tables: torch.Tensor,
                          context_lens: torch.Tensor, slots: torch.Tensor,
                          src_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Continuous-batching decode (transformer.py:509): tokens [B] at
        per-sequence positions [B], the decoder's self-attention k/v in
        per-layer paged pools (written in place, where JAX returns new
        pools; one `paged_attention` call a layer), dense
        cross-attention over `memory`. Returns logits [B, V]. Positions
        index the encoding as JAX's gather does: a negative one counts
        from the end, and the result is clamped to [0, max_len)."""
        x = self.trg_embed(token.long()[:, None]) * math.sqrt(self.model_dim)
        p = positions.long()
        p = torch.where(p < 0, p + self.max_len, p).clamp(0, self.max_len - 1)
        x = x + self.pe[p].to(x.dtype)[:, None]
        slots = slots.long()
        for layer, (k_pool, v_pool) in zip(self.dec_layers, pools):
            x = layer.decode_paged(x, memory, k_pool, v_pool, block_tables,
                                   context_lens, slots, cross_mask=src_mask)
        return self.head(self.dec_ln(x))[:, 0]


class BertEncoder(nn.Module):
    """BERT-style encoder for masked-LM pretraining (transformer.py:901):
    learned positions, the Transformer's pre-LN EncoderLayer stack, and
    an MLM head tied to the token table (`embed.attend`). `device`
    defaults to the CUDA card. The model starts in eval mode."""

    def __init__(self, vocab: int = 30522, model_dim: int = 768,
                 num_heads: int = 12, num_layers: int = 12,
                 ffn_dim: int = 3072, max_len: int = 512,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 fused_qkv: bool = False, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.model_dim = model_dim
        self.dtype = dtype
        self.embed = Embedding(vocab, model_dim, dtype=dtype, device=device)
        self.pos_embed = Embedding(max_len, model_dim, dtype=dtype,
                                   device=device)
        self.layers = nn.ModuleList(
            EncoderLayer(model_dim, num_heads, ffn_dim, dropout, dtype,
                         fused_qkv, device=device)
            for _ in range(num_layers))
        self.ln = LayerNorm(model_dim, device=device)
        self.drop = Dropout(dropout)
        self.eval()

    @staticmethod
    def check_jax_tree(tree) -> None:
        """Refuse a tree from before JAX's Embedding.attend scoping fix:
        its root-level `weight` is the untied MLM head it trained, so
        loading it as tied would change the MLM logits
        (transformer.py:952-965)."""
        if "weight" in tree.get("params", {}):
            raise ModuleError(
                "checkpoint has a root-level 'weight' param: it predates "
                "the Embedding.attend scoping fix and its MLM head was "
                "NOT tied. Migrate by renaming it into a dedicated head "
                "or folding it into params['embed']['weight'].")

    def forward(self, tokens: torch.Tensor,
                mask_positions: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Hidden states [B, T, D]; with `mask_positions` [B, K] the
        tied-head MLM vocab logits [B, K, V] at those positions instead.
        `lengths` [B] turns the padding into segment ids (real 1, pad
        0), which keeps padded batches on the flash kernels: pad rows
        attend pad rows, and their outputs are never read."""
        t = tokens.shape[1]
        pos = torch.arange(t, device=tokens.device)
        x = self.embed(tokens.long()) + self.pos_embed(pos)[None]
        x = self.drop(x, generator)
        segs = None
        if lengths is not None:
            segs = sequence_mask(lengths.to(x.device), t).to(torch.int32)
        for layer in self.layers:
            x = layer(x, segment_ids=segs, generator=generator)
        hidden = self.ln(x)
        if mask_positions is None:
            return hidden
        picked = torch.take_along_dim(
            hidden, mask_positions.long().to(hidden.device)[..., None], dim=1)
        return self.embed.attend(picked)
