"""Ragged paged attention: ONE call for a serve step's mixed batch of
decode rows and prefill chunks (port of
paddle_tpu/kernels/paged_attention.py:296-646).

The serve engine packs every row of a step — decode rows (one query
token) and prefill chunks (a window of C query tokens) — into a single
flat query array q: [T, H, D]. Each row occupies a contiguous segment
aligned to tile_q tokens; slack positions inside a row's last tile and
whole unused tiles are padding. Per-TILE metadata maps the packing back
to sequences:

- tile_rows [NT] int32: which metadata row each query tile belongs to
  (pad tiles point at a "null row" whose context_len is 1 and whose
  block table is all scratch block 0).
- tile_offs [NT] int32: the tile's token offset WITHIN its row's
  segment, so a query's absolute position is
  q_starts[row] + tile_off + (index inside the tile).
- block_tables [R, MB], context_lens [R], q_starts [R]: per-row pool
  block tables, chunk-end positions (start + q_len; 1 for the null
  row), and first-query positions.

Masking is absolute-position causal AND context-bounded
(kv_pos <= q_pos, kv_pos < ctx), so decode rows, mid-prompt chunks and
pad queries all fall out of one rule.

Two implementations with one contract:

- `ragged_paged_attention_reference` — the plain PyTorch version: dense
  gather + masked `reference_attention`. The tests use it, and the
  wrapper runs it for tensors that lie on the CPU.
- the hand-written CUDA kernel `kernels/csrc/ragged_paged_attention.cu`
  (which replaces the TPU kernel `_ragged_kernel`,
  paddle_tpu/kernels/paged_attention.py:428). For CUDA tensors the
  wrapper launches it or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.attention import reference_attention

_KERNEL = "ragged_paged_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM_BYTES = 232448          # one CTA's dynamic shared memory on H100


def ragged_paged_attention_reference(q, k_pool, v_pool, block_tables,
                                     context_lens, q_starts, tile_rows,
                                     tile_offs,
                                     scale: Optional[float] = None):
    """Plain version for the ragged layout: expand tile metadata to
    per-token rows and run the dense gather + masked attention.
    q: [T, H, D] flat-packed; returns [T, H, D] in q's dtype.

    Gathers [T, MB*BS, Hkv, D] (every token re-gathers its row's
    blocks), like the JAX oracle; masked lanes are selected to NEG_INF
    and underflow to exact zeros, so the scratch contents of padded
    table entries never reach a real row."""
    t, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    nt = tile_rows.shape[0]
    if t % nt:
        raise ValueError(f"flat length {t} not a multiple of {nt} tiles")
    tq = t // nt
    mb = block_tables.shape[1]
    tile_rows = tile_rows.long()
    row_of = tile_rows.repeat_interleave(tq)                     # [T]
    qpos = ((q_starts.long()[tile_rows] + tile_offs.long())
            .repeat_interleave(tq)
            + torch.arange(tq, device=q.device).repeat(nt))      # [T]
    bt = block_tables.long()[row_of]                             # [T, MB]
    k = k_pool[bt].reshape(t, mb * bs, hkv, d)
    v = v_pool[bt].reshape(t, mb * bs, hkv, d)
    kv_pos = torch.arange(mb * bs, device=q.device)
    ctx = context_lens.long()[row_of]
    mask = ((kv_pos[None, :] <= qpos[:, None])
            & (kv_pos[None, :] < ctx[:, None]))[:, None, None, :]
    return reference_attention(q[:, None].to(k.dtype), k, v, mask=mask,
                               scale=scale)[:, 0].to(q.dtype)


def _check_operands(q, k_pool, v_pool, block_tables, context_lens, q_starts,
                    tile_rows, tile_offs) -> None:
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"expected q [T, H, D] and pools [NB, BS, Hkv, D]; got q "
            f"{tuple(q.shape)}, k_pool {tuple(k_pool.shape)}, v_pool "
            f"{tuple(v_pool.shape)}")
    t, h, d = q.shape
    hkv = k_pool.shape[2]
    if k_pool.shape[3] != d:
        raise ValueError(f"head dim {d} != pool head dim {k_pool.shape[3]}")
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    r = block_tables.shape[0]
    if (block_tables.dim() != 2 or context_lens.shape != (r,)
            or q_starts.shape != (r,) or tile_rows.dim() != 1
            or tile_offs.shape != tile_rows.shape):
        raise ValueError("expected block_tables [R, MB], context_lens/"
                         "q_starts [R], tile_rows/tile_offs [NT]")
    nt = tile_rows.shape[0]
    if nt == 0 or t % nt:
        raise ValueError(f"flat length {t} not a multiple of {nt} tiles")


def _check_block_ids(block_tables, num_blocks: int) -> None:
    lo, hi = int(block_tables.min()), int(block_tables.max())
    if lo < 0 or hi >= num_blocks:
        raise ValueError(f"block ids span [{lo}, {hi}], outside the pool's "
                         f"[0, {num_blocks})")


def _library() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    fn = lib.ptt_ragged_paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 7 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        smem = lib.ptt_ragged_paged_attention_smem_bytes
        smem.argtypes = [i] * 4
        smem.restype = ctypes.c_size_t
        lib.ptt_cuda_error_string.argtypes = [i]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def shared_memory_bytes(tile_q: int, groups: int, head_dim: int,
                        block_size: int) -> int:
    """Dynamic shared memory one CTA of the kernel takes (the kernel's
    own count, so a caller can report it beside ptxas's registers)."""
    return int(_library().ptt_ragged_paged_attention_smem_bytes(
        tile_q, groups, head_dim, block_size))


def _launch(q, k_pool, v_pool, block_tables, context_lens, q_starts,
            tile_rows, tile_offs, scale: float) -> torch.Tensor:
    t, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    nt = tile_rows.shape[0]
    tq = t // nt
    ints = (block_tables, context_lens, q_starts, tile_rows, tile_offs)
    floats = (q, k_pool, v_pool)
    for x in floats + ints:
        if x.device != q.device:
            raise ValueError(f"operands on {x.device} and {q.device}")
        if not x.is_contiguous():
            raise ValueError("ragged_paged_attention needs contiguous "
                             "operands")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools {k_pool.dtype}/{v_pool.dtype} must match q "
                        f"{q.dtype}")
    if any(x.dtype != torch.int32 for x in ints):
        raise TypeError("block_tables, context_lens, q_starts, tile_rows "
                        "and tile_offs must be int32")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d} must be a multiple of 8, <= 256")
    if any(x.data_ptr() % 16 for x in floats):
        raise ValueError("q and pools must be 16-byte aligned")
    lib = _library()
    smem = shared_memory_bytes(tq, h // hkv, d, bs)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"tile_q={tq} x groups={h // hkv} x head_dim={d} with "
            f"block_size={bs} needs {smem} B of shared memory per CTA, "
            f"over the card's {_MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ptt_ragged_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(),
            q_starts.data_ptr(), tile_rows.data_ptr(), tile_offs.data_ptr(),
            out.data_ptr(), nt, tq, h, hkv, d, bs, block_tables.shape[1],
            float(scale), _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        msg = lib.ptt_cuda_error_string(rc).decode()
        raise RuntimeError(f"ragged_paged_attention launch failed: "
                           f"cudaError {rc} ({msg})")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                           q_starts, tile_rows, tile_offs,
                           scale: Optional[float] = None,
                           check_block_ids: bool = False):
    """Mixed prefill+decode attention over the flat ragged packing — the
    engine's single-step entry point. Dispatch is by the tensors'
    device: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (launched or raised, never replaced). `check_block_ids` is
    the debug check that every block id lies in [0, NB): a CUDA kernel
    would read garbage where JAX clamps (it syncs with the device)."""
    _check_operands(q, k_pool, v_pool, block_tables, context_lens, q_starts,
                    tile_rows, tile_offs)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if check_block_ids:
        _check_block_ids(block_tables, k_pool.shape[0])
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pool, v_pool, block_tables, context_lens, q_starts,
            tile_rows, tile_offs, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged_paged_attention for device {q.device}")
    return _launch(q, k_pool, v_pool, block_tables, context_lens, q_starts,
                   tile_rows, tile_offs, scale)


# kernel launches since the last reset (set to 0 to reset); the plain
# version on CPU tensors does not count
ragged_paged_attention.launches = 0
