"""Operands and weights made from a seed with numpy, shared by the port's
tests and chip_smoke.py (counterpart of paddle_tpu/testing/).

Everything here returns numpy arrays, so one set of inputs can go
through the JAX package and through the port alike.
"""

from __future__ import annotations

import json
import os
import zlib
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
QUANT_ARGS = ("kq_pool", "vq_pool", "k_scales", "v_scales")


def int8_blocks(case: Dict[str, np.ndarray], which="odd",
                dtype=None) -> Tuple[Dict[str, np.ndarray],
                                     Dict[str, np.ndarray], int]:
    """Move some referenced blocks of a ragged case into int8 slots, as
    the engine's compressed tier does. `which`: "odd" takes the blocks
    at odd table positions, "all" every block a row reads, or a
    callable (row, table position, row's q_start) -> bool. Returns
    (mixed, promoted, count): `mixed` is the case with a bias-encoded
    table (block b -> -(slot+1)) and QUANT_ARGS added; `promoted` the
    case with those blocks' fp content replaced by dequantize_block of
    their int8 copy — what a promote writes. A direct read of `mixed`
    must equal a read of `promoted` bit for bit. `dtype` (a torch
    dtype, default f32) is the pool dtype the promotion casts to; the
    pools come back in that dtype's values, stored as float32."""
    import torch

    from paddle_tpu_torch.quant.int8_compute import (dequantize_block,
                                                     quantize_block)
    pick = which if callable(which) else (
        lambda row, j, q_start: which == "all" or j % 2 == 1)
    dtype = dtype or torch.float32
    bt = case["block_tables"]
    bs = case["k_pool"].shape[1]
    k = torch.from_numpy(case["k_pool"]).to(dtype)
    v = torch.from_numpy(case["v_pool"]).to(dtype)
    picks: List[int] = []
    for i in range(bt.shape[0] - 1):              # the last row is null
        for j in range(-(-int(case["context_lens"][i]) // bs)):
            b = int(bt[i, j])
            if b not in picks and pick(i, j, int(case["q_starts"][i])):
                picks.append(b)
    if not picks:
        raise ValueError("no block picked for the int8 tier")
    idx = torch.tensor(picks, dtype=torch.long)
    kq, ks = quantize_block(k[idx])
    vq, vs = quantize_block(v[idx])
    k_pro, v_pro = k.clone(), v.clone()
    k_pro[idx] = dequantize_block(kq, ks, dtype)
    v_pro[idx] = dequantize_block(vq, vs, dtype)
    slot_of = {b: s for s, b in enumerate(picks)}
    bt_mixed = np.vectorize(lambda b: -(slot_of[b] + 1) if b in slot_of
                            else b, otypes=[np.int32])(bt)
    f32 = {"k_pool": k.float().numpy(), "v_pool": v.float().numpy()}
    mixed = dict(case, **f32, block_tables=bt_mixed, kq_pool=kq.numpy(),
                 vq_pool=vq.numpy(), k_scales=ks.numpy(),
                 v_scales=vs.numpy())
    promoted = dict(case, k_pool=k_pro.float().numpy(),
                    v_pool=v_pro.float().numpy())
    return mixed, promoted, len(picks)


PAGED_ARGS = ("q", "k_pool", "v_pool", "block_tables", "context_lens")


def paged_case(context_lens: Sequence[int], h: int, hkv: int, d: int,
               bs: int, num_blocks: Optional[int] = None,
               max_blocks: Optional[int] = None,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Operands of one single-token paged decode call (keys in
    PAGED_ARGS order): q [B, H, D], pools [NB, BS, Hkv, D] float32,
    shuffled block tables [B, MB] (unused entries scratch block 0) and
    context_lens [B] int32."""
    rng = np.random.default_rng(seed)
    need = [-(-ctx // bs) for ctx in context_lens]
    num_blocks = num_blocks or sum(need) + 1
    max_blocks = max_blocks or max(need)
    ids = rng.permutation(np.arange(1, num_blocks))
    if sum(need) > len(ids) or max(need) > max_blocks:
        raise ValueError("pool or table too small for the rows")
    bt = np.zeros((len(context_lens), max_blocks), np.int32)
    used = 0
    for i, n in enumerate(need):
        bt[i, :n] = ids[used:used + n]
        used += n
    shape = (num_blocks, bs, hkv, d)
    return {
        "q": rng.standard_normal((len(context_lens), h, d), np.float32),
        "k_pool": rng.standard_normal(shape, np.float32),
        "v_pool": rng.standard_normal(shape, np.float32),
        "block_tables": bt,
        "context_lens": np.asarray(context_lens, np.int32),
    }


def decode_as_ragged(case: Dict[str, np.ndarray],
                     tile_q: int) -> Dict[str, np.ndarray]:
    """A paged_case's decode rows as ragged decode rows (keys in
    RAGGED_ARGS order): one tile of tile_q queries a sequence, its query
    in the tile's first slot at position ctx - 1 (the other slots are
    slack, zeros), the same pools, tables and contexts. Row b's output is
    flat row b * tile_q of the ragged call. Every context must be >= 1."""
    q, cl = case["q"], case["context_lens"]
    if (cl < 1).any():
        raise ValueError("a ragged row needs a context of at least 1")
    b = q.shape[0]
    flat = np.zeros((b * tile_q,) + q.shape[1:], q.dtype)
    flat[::tile_q] = q
    return {"q": flat, "k_pool": case["k_pool"], "v_pool": case["v_pool"],
            "block_tables": case["block_tables"], "context_lens": cl,
            "q_starts": (cl - 1).astype(np.int32),
            "tile_rows": np.arange(b, dtype=np.int32),
            "tile_offs": np.zeros((b,), np.int32)}


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


def write_serving_export(path: str, tree: Dict, serve_meta: Dict) -> str:
    """Write the part of a JAX `save_inference_model` directory that
    `ServeEngine.from_saved_model` reads, with numpy only:
    `signature.json` carrying the `serve` block, and the `params`
    checkpoint in format version 2 (manifest.json with per-file CRC32s,
    shards-p0.npz, shard_index-p0.json; paddle_tpu/io/checkpoint.py
    :18-33). Every leaf is one whole piece. Returns `path`."""
    flat: List[Tuple[str, np.ndarray]] = []

    def walk(node, prefix):
        for key in sorted(node):
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(node[key], dict):
                walk(node[key], name)
            else:
                flat.append((name, np.asarray(node[key])))
    walk(tree, "")
    params = os.path.join(path, "params")
    os.makedirs(params, exist_ok=True)
    slots = {f"a{i}_s{i}": arr for i, (_, arr) in enumerate(flat)}
    np.savez(os.path.join(params, "shards-p0.npz"), **slots)
    index = [{"leaf": i, "slot": f"a{i}_s{i}",
              "index": [[0, d] for d in arr.shape]}
             for i, (_, arr) in enumerate(flat)]
    with open(os.path.join(params, "shard_index-p0.json"), "w") as f:
        json.dump(index, f)
    files = {}
    for name in ("shard_index-p0.json", "shards-p0.npz"):
        with open(os.path.join(params, name), "rb") as f:
            data = f.read()
        files[name] = {"crc32": zlib.crc32(data), "bytes": len(data)}
    manifest = {"version": 2, "step": None, "metadata": {},
                "process_count": 1, "files": files,
                "leaves": [{"key": k, "shape": list(a.shape),
                            "dtype": str(a.dtype)} for k, a in flat]}
    with open(os.path.join(params, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    with open(os.path.join(path, "signature.json"), "w") as f:
        json.dump({"version": 1, "serve": dict(serve_meta)}, f, indent=1)
    return path


FLASH_ARGS = ("q", "k", "v", "do")


def flash_case(b: int, t_q: int, t_k: int, h: int, d: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Operands of one flash attention call and its backward (keys in
    FLASH_ARGS order), float32 N(0, 1): q and the cotangent do
    [B, Tq, H, D], k/v [B, Tk, H, D]."""
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((b, t_q, h, d), np.float32),
            "k": rng.standard_normal((b, t_k, h, d), np.float32),
            "v": rng.standard_normal((b, t_k, h, d), np.float32),
            "do": rng.standard_normal((b, t_q, h, d), np.float32)}


def packed_segment_ids(lengths: Sequence[int], t: int) -> np.ndarray:
    """One row of segment ids [t] int32: consecutive documents of
    `lengths`, the rest of the row a segment of its own."""
    ids = np.full((t,), len(lengths), np.int32)
    pos = 0
    for i, n in enumerate(lengths):
        ids[pos:pos + n] = i
        pos += n
    return ids


def lm_stream(rng: np.random.Generator, batch: int, seq: int,
              vocab: int) -> Tuple[np.ndarray, np.ndarray]:
    """The learnable token stream of examples/train_causal_lm.py:36-40
    (next token = token + 3 mod vocab): (inputs, targets) [batch, seq]
    int32."""
    start = rng.integers(0, vocab, (batch, 1))
    rows = ((start + np.arange(seq + 1)[None, :] * 3) % vocab).astype(
        np.int32)
    return rows[:, :-1], rows[:, 1:]


# The out-of-vocabulary serving case: a V-61 CausalLM (head dim 8, the
# kernels' smallest) with causal_lm_tree(0, ...) weights on a 5-block
# pool. The first batch's second prompt holds the id V (a NaN embedding
# row, so NaN K/V in its blocks); each later request reuses blocks it
# freed, one hits its cached prompt block, and the last batch counts
# -V from the end and holds the out-of-vocabulary -V - 1. Greedy,
# OOV_NEW_TOKENS new tokens a request.
OOV_VOCAB = 61
OOV_DIMS = dict(model_dim=32, num_heads=4, num_layers=2, ffn_dim=32,
                num_kv_heads=2)
OOV_ENGINE = dict(max_batch_size=4, block_size=4, num_blocks=6,
                  max_prefill_tokens=8, tile_q=4)
OOV_PROMPTS = [[[5, 9, 2], [7, 1, OOV_VOCAB, 3]], [[2, 8]],
               [[6, 6, 6, 6, 6, 1]], [[4] * 8 + [9]], [[-1, 4, 2]],
               [[7, 1, OOV_VOCAB, 3, 5]],
               [[-OOV_VOCAB, 3], [-OOV_VOCAB - 1, 3]]]
OOV_NEW_TOKENS = 4
# The JAX engine's streams through its Pallas kernel, which reads a
# row's kv blocks only up to its context. Its XLA reference reads every
# table entry, so a stale NaN in a block past the context meets p = 0
# in P.V (0 * NaN), and differs at the fourth request ([0, 0, 0, 13]).
# The port's kernel follows the first, its plain version the second.
OOV_KERNEL_STREAMS = [[[9, 9, 9, 13], [0, 0, 0, 0]], [[15, 15, 15, 13]],
                      [[0, 0, 0, 0]], [[9, 13, 13, 13]], [[15, 9, 0, 0]],
                      [[0, 0, 0, 0]], [[3, 9, 9, 0], [0, 0, 0, 0]]]
