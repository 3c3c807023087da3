"""Operands and weights made from a seed with numpy, shared by the port's
tests and chip_smoke.py (counterpart of paddle_tpu/testing/).

Everything here returns numpy arrays, so one set of inputs can go
through the JAX package and through the port alike.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def ragged_case(rows: Sequence[Tuple[int, int]], h: int, hkv: int, d: int,
                bs: int, tq: int, num_blocks: Optional[int] = None,
                max_blocks: Optional[int] = None, pad_tiles: int = 1,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """Flat-packed operands of one ragged attention call, float32 and
    int32. `rows` holds (context_len, q_len) per row: the row's queries
    are the window [ctx - q_len, ctx) of its sequence (q_len 1 is a
    decode row, q_len == ctx a whole prompt, anything between a
    mid-prompt chunk). Block ids are a random permutation (contiguous
    tables would hide gather bugs); the null row (ctx 1, scratch
    table) backs `pad_tiles` trailing pad tiles. Keys are the
    positional argument names of ragged_paged_attention."""
    rng = np.random.default_rng(seed)
    r = len(rows)
    need = [-(-ctx // bs) for ctx, _ in rows]
    num_blocks = num_blocks or sum(need) + 1
    max_blocks = max_blocks or max(need)
    ids = rng.permutation(np.arange(1, num_blocks))
    if sum(need) > len(ids) or max(need) > max_blocks:
        raise ValueError("pool or table too small for the rows")
    bt = np.zeros((r + 1, max_blocks), np.int32)
    cl = np.ones((r + 1,), np.int32)
    qs = np.zeros((r + 1,), np.int32)
    nt = sum(-(-q // tq) for _, q in rows) + pad_tiles
    tile_rows = np.full((nt,), r, np.int32)
    tile_offs = np.zeros((nt,), np.int32)
    used = cursor = 0
    for i, (ctx, qlen) in enumerate(rows):
        bt[i, :need[i]] = ids[used:used + need[i]]
        used += need[i]
        cl[i], qs[i] = ctx, ctx - qlen
        for k in range(-(-qlen // tq)):
            tile_rows[cursor // tq + k] = i
            tile_offs[cursor // tq + k] = k * tq
        cursor += -(-qlen // tq) * tq
    shape = (num_blocks, bs, hkv, d)
    return {
        "q": rng.standard_normal((nt * tq, h, d), np.float32),
        "k_pool": rng.standard_normal(shape, np.float32),
        "v_pool": rng.standard_normal(shape, np.float32),
        "block_tables": bt, "context_lens": cl, "q_starts": qs,
        "tile_rows": tile_rows, "tile_offs": tile_offs,
    }


RAGGED_ARGS = ("q", "k_pool", "v_pool", "block_tables", "context_lens",
               "q_starts", "tile_rows", "tile_offs")


def causal_lm_tree(seed: int, vocab: int, model_dim: int, num_heads: int,
                   num_layers: int, ffn_dim: int,
                   num_kv_heads: Optional[int] = None,
                   fused_qkv: bool = False, tie_embeddings: bool = True,
                   embed_std: float = 0.02, random_norms: bool = False
                   ) -> Dict:
    """A JAX-layout CausalLM `variables` tree of random weights:
    glorot-uniform Linear weights [in, out], N(0, embed_std)
    embeddings, and zero biases with unit LayerNorm scales (the JAX
    initializers' distributions) unless `random_norms`, which draws
    them too so a parity test exercises every parameter."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def vec(n, base):
        if random_norms:
            return (base + 0.1 * rng.standard_normal(n)).astype(f32)
        return np.full((n,), base, f32)

    def linear(n_in, n_out):
        lim = np.sqrt(6.0 / (n_in + n_out))
        return {"weight": rng.uniform(-lim, lim, (n_in, n_out)).astype(f32),
                "bias": vec(n_out, 0.0)}

    def ln():
        return {"scale": vec(model_dim, 1.0), "bias": vec(model_dim, 0.0)}

    hkv = num_kv_heads or num_heads
    kv_dim = hkv * (model_dim // num_heads)
    params = {"embed": {"weight": (embed_std * rng.standard_normal(
        (vocab, model_dim))).astype(f32)}}
    for i in range(num_layers):
        attn = ({"qkv": linear(model_dim, 3 * model_dim)} if fused_qkv else
                {"q_proj": linear(model_dim, model_dim),
                 "k_proj": linear(model_dim, kv_dim),
                 "v_proj": linear(model_dim, kv_dim)})
        attn["out_proj"] = linear(model_dim, model_dim)
        params[f"blocks_{i}"] = {
            "ln1": ln(), "ln2": ln(), "attn": attn,
            "ffn": {"fc1": linear(model_dim, ffn_dim),
                    "fc2": linear(ffn_dim, model_dim)}}
    params["ln_f"] = ln()
    if not tie_embeddings:
        params["head"] = linear(model_dim, vocab)
    return {"params": params}


STEP_ARGS = ("tokens", "positions", "block_tables", "context_lens",
             "q_starts", "tile_rows", "tile_offs", "slots", "last_idx")


def pack_prompts(prompts: List[List[int]], bs: int, tq: int,
                 max_blocks: int, pad_tiles: int = 1
                 ) -> Tuple[Dict[str, np.ndarray], int]:
    """Hand-packed operands of one ragged serve step that runs each
    prompt as one whole-prompt chunk from position 0 (keys in
    STEP_ARGS order: CausalLM.ragged_step_paged's operands after the
    pools), blocks handed out in order from block 1, pad tiles on the
    null row. Returns (operands, blocks used including scratch 0)."""
    r = len(prompts)
    nt = sum(-(-len(p) // tq) for p in prompts) + pad_tiles
    t = nt * tq
    ops = {
        "tokens": np.zeros(t, np.int32), "positions": np.zeros(t, np.int32),
        "block_tables": np.zeros((r + 1, max_blocks), np.int32),
        "context_lens": np.ones(r + 1, np.int32),
        "q_starts": np.zeros(r + 1, np.int32),
        "tile_rows": np.full(nt, r, np.int32),
        "tile_offs": np.zeros(nt, np.int32),
        "slots": np.zeros(t, np.int32), "last_idx": np.zeros(r, np.int32),
    }
    cursor, block = 0, 1
    for i, p in enumerate(prompts):
        n = len(p)
        nblk = -(-n // bs)
        table = np.arange(block, block + nblk, dtype=np.int32)
        ops["block_tables"][i, :nblk] = table
        ops["tokens"][cursor:cursor + n] = p
        ops["positions"][cursor:cursor + n] = np.arange(n)
        ops["slots"][cursor:cursor + n] = [table[j // bs] * bs + j % bs
                                           for j in range(n)]
        ops["context_lens"][i] = n
        ops["last_idx"][i] = cursor + n - 1
        for k in range(-(-n // tq)):
            ops["tile_rows"][cursor // tq + k] = i
            ops["tile_offs"][cursor // tq + k] = k * tq
        cursor += -(-n // tq) * tq
        block += nblk
    return ops, block
