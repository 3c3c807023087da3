"""Paged attention of the port (port of
paddle_tpu/kernels/paged_attention.py:108-162, 296-646): attention
whose K/V is gathered through per-sequence block tables from block
pools [NB, BS, Hkv, D].

Single-token decode (`paged_attention`, the split path's decode step)
and chunked prefill (`paged_prefill_attention`, plain only, as JAX
left it to XLA) take one batch row per sequence; the serve engine's
step instead takes ONE call for its mixed batch of decode rows and
prefill chunks (`ragged_paged_attention`), described below.

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

With the engine's in-device int8 tier on, the call also takes int8
pools kq/vq [NQ, BS, Hkv, D] and per-block f32 scales [NQ], and the
block table is bias-encoded: id >= 0 is an fp block, id < 0 is int8
slot -id-1, dequantized in place exactly as `dequantize_block` does.

Each kernel has two implementations with one contract:

- a plain PyTorch version (`*_reference`): dense gather + masked
  `reference_attention`. The tests use it, and the wrappers run it for
  tensors that lie on the CPU.
- a hand-written CUDA kernel under kernels/csrc/. For CUDA tensors the
  wrapper launches it or raises; it never falls back. All three are
  entry points of `ragged_paged_attention.cu` over one kernel pair
  (`ragged_tc.cuh`): a split kernel over fixed-position kv splits and,
  where a tile spans more than one split, a kernel that combines the
  splits in order (`ragged_plan` sizes both):
  - `ptt_ragged_paged_attention` replaces `_ragged_kernel`
    (paddle_tpu/kernels/paged_attention.py:428), and
    `ptt_ragged_paged_attention_mixed` replaces `_ragged_kernel_mixed`
    (:462);
  - `ptt_paged_attention` replaces `_paged_kernel` (:173): each sequence
    is one decode tile (tile_q 1, its query heads of a kv head as the
    tile's rows), through kernel 1's instantiations and kv schedule.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.attention import reference_attention
from paddle_tpu_torch.quant.int8_compute import RQMAX

_KERNEL = "ragged_paged_attention"
_KERNELS = (_KERNEL, "paged_attention")   # both run the ragged kernel pair
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM_BYTES = 232448          # one CTA's dynamic shared memory on H100

# The ragged kernels' kv schedule (csrc/ragged_tc.cuh). It is anchored at
# position 0 of every row and depends on the dtype and head dim only, so
# a query's output bits do not depend on how its prompt was chunked.
RAGGED_SPLIT = 256        # S: kv positions one CTA walks
RAGGED_LANES = 16         # kv positions a warp takes of each chunk
# depth of the K/V ring in shared memory, by element bytes: bf16 overlaps
# a chunk's copies with the previous chunk's products; f32 gains more from
# the CTAs a single stage lets share an SM
RAGGED_STAGES = {2: 2, 4: 1}


class RaggedSchedule(NamedTuple):
    """How one ragged call is cut: `chunk` (C) kv positions an iteration,
    one warp per 16 of them; `split` (S) kv positions a CTA. A CTA holds
    `warp_rows` query rows of one tile, `row_groups` CTAs a tile's
    tile_q * G rows. `threads` and `smem_bytes` of a split-kernel CTA."""
    chunk: int
    split: int
    warp_rows: int
    row_groups: int
    threads: int
    smem_bytes: int


def ragged_split_blocks(split: int, block_size: int) -> int:
    """Table entries the positions of one split span at most."""
    return (split - 1) // block_size + 2


def ragged_smem_bytes(head_dim: int, elem_bytes: int, chunk: int,
                      split: int, block_size: int, rows: int) -> int:
    """Dynamic shared memory of one split-kernel CTA (the source's
    smem_bytes): the K/V ring and the CTA's `rows` q rows, each row
    padded (bf16: the head dim to the mma's k16) plus 16 bytes, and the
    split's table entries and their two int8 scales (each array rounded
    up to 16 bytes); then, reusing it, the warps' f32 states of those
    rows with each row's max and l."""
    dk = -(-head_dim // 16) * 16 if elem_bytes == 2 else head_dim
    row_bytes = (dk + 16 // elem_bytes) * elem_bytes
    walk = ((RAGGED_STAGES[elem_bytes] * 2 * chunk + rows) * row_bytes
            + 3 * ((ragged_split_blocks(split, block_size) + 3) // 4 * 16))
    merge = (chunk // RAGGED_LANES * (head_dim + 2) + 2) * rows * 4
    return max(walk, merge)


@functools.lru_cache(maxsize=None)
def ragged_schedule(dtype: torch.dtype, head_dim: int, rows: int,
                    block_size: int) -> RaggedSchedule:
    """The schedule of a ragged call in `dtype` at `head_dim`, for tiles
    of `rows` = tile_q * G query rows over blocks of `block_size`. C is 64
    (four warps of 16 lanes) except f32 above head dim 128, where 32
    halves a stage of K/V; a bf16 CTA holds 16 query rows (an mma tile),
    an f32 one 8. C and S depend on the dtype and head dim only."""
    bf16 = dtype == torch.bfloat16
    elem = 2 if bf16 else 4
    chunk = 32 if (not bf16 and head_dim > 128) else 64
    warp_rows = 16 if bf16 else 8
    return RaggedSchedule(
        chunk=chunk, split=RAGGED_SPLIT, warp_rows=warp_rows,
        row_groups=-(-rows // warp_rows),
        threads=chunk // RAGGED_LANES * 32,
        smem_bytes=ragged_smem_bytes(head_dim, elem, chunk, RAGGED_SPLIT,
                                     block_size, warp_rows))


def ragged_num_splits(max_blocks: int, block_size: int,
                      split: int = RAGGED_SPLIT) -> int:
    """Splits of a table of max_blocks blocks: the split kernel launches
    that many CTAs per tile (one past the tile's last block returns at
    once)."""
    return -(-max_blocks * block_size // split)


def ragged_workspace_shape(num_tiles: int, num_kv_heads: int, splits: int,
                           rows: int, head_dim: int) -> Tuple[int, ...]:
    """The f32 partials of a call: per (tile, kv head, split, query row)
    acc [D], then m and l."""
    return (num_tiles, num_kv_heads, splits, rows, head_dim + 2)


class RaggedPlan(NamedTuple):
    """One call of the kernel pair: its schedule, the splits of its
    table, and the shape of its f32 partials (None with one split, where
    every tile writes its output)."""
    schedule: RaggedSchedule
    splits: int
    workspace: Optional[Tuple[int, ...]]


def ragged_plan(dtype: torch.dtype, num_tiles: int, tile_q: int,
                num_heads: int, num_kv_heads: int, head_dim: int,
                block_size: int, max_blocks: int) -> RaggedPlan:
    """The plan of a call over `num_tiles` tiles of tile_q queries (a
    decode call: one tile a sequence, tile_q 1) with tables of
    max_blocks blocks; pure Python, what the wrappers launch from."""
    rows = tile_q * (num_heads // num_kv_heads)
    sched = ragged_schedule(dtype, head_dim, rows, block_size)
    splits = ragged_num_splits(max_blocks, block_size, sched.split)
    return RaggedPlan(sched, splits, ragged_workspace_shape(
        num_tiles, num_kv_heads, splits, rows, head_dim)
        if splits > 1 else None)


def paged_attention_reference(q, k_pool, v_pool, block_tables,
                              context_lens, scale: Optional[float] = None):
    """Plain single-token decode: gather blocks dense, mask past
    context_len, run reference_attention. q: [B, H, D]; pools:
    [NB, BS, Hkv, D]; block_tables: [B, MB] int32; context_lens: [B]
    int32 -> [B, H, D] in q's dtype."""
    b, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pool[bt].reshape(b, mb * bs, hkv, d)
    v = v_pool[bt].reshape(b, mb * bs, hkv, d)
    mask = (torch.arange(mb * bs, device=q.device)[None, :]
            < context_lens.long()[:, None])[:, None, None, :]
    return reference_attention(q[:, None].to(k.dtype), k, v, mask=mask,
                               scale=scale)[:, 0].to(q.dtype)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, context_lens,
                            q_positions, scale: Optional[float] = None):
    """Chunked-prefill attention through the block table, plain PyTorch
    only (JAX left it to XLA, with no Pallas kernel): a CHUNK of
    queries per sequence attends, causally, over the prefix KV already
    in the pool AND the chunk's own KV (the caller scatters the chunk's
    k/v into the pool first).

    q: [B, C, H, D]; q_positions: [B, C] int32 absolute position of
    each query; pools [NB, BS, Hkv, D]; block_tables [B, MB];
    context_lens [B] int32, each row's chunk-end position (1 for pad
    rows). A gathered slot's position IS its index in table order, so
    the mask is kv_pos <= q_pos AND kv_pos < ctx. Returns
    [B, C, H, D]."""
    b, c, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pool[bt].reshape(b, mb * bs, hkv, d)
    v = v_pool[bt].reshape(b, mb * bs, hkv, d)
    kv_pos = torch.arange(mb * bs, device=q.device)
    mask = ((kv_pos[None, None, :] <= q_positions.long()[:, :, None])
            & (kv_pos[None, None, :]
               < context_lens.long()[:, None, None]))
    return reference_attention(q.to(k.dtype), k, v, mask=mask[:, None],
                               scale=scale).to(q.dtype)


def _gather_mixed(pool, q_pool, scales, ids):
    """Dense mixed-tier gather for the plain version: fp pool rows where
    the bias-encoded table entry is >= 0, per-block dequantized int8
    rows where it is < 0. Dequant is dequantize_block's identity —
    (int8 -> f32) * (scale * RQMAX), cast to the fp pool dtype — so a
    direct read returns exactly the bytes a promote would have
    written."""
    neg = ids < 0
    dense = pool[torch.where(neg, 0, ids)]             # [..., BS, Hkv, D]
    q_ids = torch.where(neg, -ids - 1, 0)
    deq = (q_pool[q_ids].float()
           * (scales[q_ids] * RQMAX)[..., None, None, None]).to(pool.dtype)
    return torch.where(neg[..., None, None, None], deq, dense)


def ragged_paged_attention_reference(q, k_pool, v_pool, block_tables,
                                     context_lens, q_starts, tile_rows,
                                     tile_offs,
                                     scale: Optional[float] = None,
                                     kq_pool=None, vq_pool=None,
                                     k_scales=None, v_scales=None):
    """Plain version for the ragged layout: expand tile metadata to
    per-token rows and run the dense gather + masked attention.
    q: [T, H, D] flat-packed; returns [T, H, D] in q's dtype.

    Gathers [T, MB*BS, Hkv, D] (every token re-gathers its row's
    blocks), like the JAX oracle; masked lanes are selected to NEG_INF
    and underflow to exact zeros, so finite scratch contents of padded
    table entries never reach a real row (a NaN there does, as 0 * NaN
    in P.V, as in the JAX oracle; the kernel, like the Pallas kernel,
    reads no block past a row's context). With kq_pool/vq_pool (and
    [NQ] k_scales/v_scales) the table is bias-encoded and int8 blocks
    are dequantized inside the gather (_gather_mixed)."""
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
    if kq_pool is None:
        k, v = k_pool[bt], v_pool[bt]
    else:
        k = _gather_mixed(k_pool, kq_pool, k_scales, bt)
        v = _gather_mixed(v_pool, vq_pool, v_scales, bt)
    k = k.reshape(t, mb * bs, hkv, d)
    v = v.reshape(t, mb * bs, hkv, d)
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


def _check_quant_operands(k_pool, kq_pool, vq_pool, k_scales,
                          v_scales) -> None:
    quant = (kq_pool, vq_pool, k_scales, v_scales)
    if any(x is None for x in quant):
        raise ValueError("kq_pool, vq_pool, k_scales and v_scales go "
                         "together")
    nq = kq_pool.shape[0]
    if (kq_pool.shape[1:] != k_pool.shape[1:] or vq_pool.shape != kq_pool.shape
            or k_scales.shape != (nq,) or v_scales.shape != (nq,)):
        raise ValueError(
            f"expected int8 pools [NQ, BS, Hkv, D] like the fp pools' "
            f"{tuple(k_pool.shape[1:])} and scales [NQ]; got kq "
            f"{tuple(kq_pool.shape)}, vq {tuple(vq_pool.shape)}, scales "
            f"{tuple(k_scales.shape)}/{tuple(v_scales.shape)}")


def _check_block_ids(block_tables, num_blocks: int, num_q: int = 0) -> None:
    """Every id in [-num_q, num_blocks): negative ids are the int8 slots
    of a bias-encoded table, and exist only when int8 pools are given."""
    lo, hi = int(block_tables.min()), int(block_tables.max())
    if lo < -num_q or hi >= num_blocks:
        raise ValueError(f"block ids span [{lo}, {hi}], outside the pools' "
                         f"[{-num_q}, {num_blocks})")


_TYPED: set = set()       # libraries whose entry points carry argtypes


def _library() -> ctypes.CDLL:
    """The built library of the paged kernels, its entry points typed."""
    lib = build.load(_KERNEL)
    if _KERNEL not in _TYPED:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn_name, args in (
                ("ptt_ragged_paged_attention", [p] * 10 + [i] * 9),
                ("ptt_ragged_paged_attention_mixed", [p] * 14 + [i] * 9),
                ("ptt_paged_attention", [p] * 7 + [i] * 8)):
            fn = getattr(lib, fn_name)
            fn.argtypes = args + [f, i, p]
            fn.restype = ctypes.c_int
        lib.ptt_ragged_paged_attention_smem_bytes.argtypes = [i] * 5
        lib.ptt_ragged_paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.ptt_cuda_error_string.argtypes = [i]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
        _TYPED.add(_KERNEL)
    return lib


def shared_memory_bytes(tile_q: int, groups: int, head_dim: int,
                        block_size: int, kernel: str = _KERNEL,
                        dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory one split-kernel CTA of `kernel` (the ragged
    call, or the paged-decode call with tile_q 1) takes in `dtype`, so a
    caller can report it beside ptxas's registers; from the schedule, in
    pure Python."""
    if kernel not in _KERNELS:
        raise ValueError(f"no kernel {kernel!r}; one of {_KERNELS}")
    return ragged_schedule(dtype, head_dim, tile_q * groups,
                           block_size).smem_bytes


def library_smem_bytes(dtype: torch.dtype, head_dim: int, rows: int,
                       block_size: int) -> int:
    """The ragged library's own count of a split-kernel CTA's shared
    memory for ragged_schedule(dtype, head_dim, rows, block_size) (the
    card's tests hold the Python count to it)."""
    sched = ragged_schedule(dtype, head_dim, rows, block_size)
    return int(_library().ptt_ragged_paged_attention_smem_bytes(
        head_dim, 2 if dtype == torch.bfloat16 else 4, sched.chunk,
        sched.split, block_size))


def _check_launch(name: str, q, floats, ints, quant=()) -> None:
    """What every CUDA entry point needs of its operands: one device,
    contiguous, f32/bf16 q and pools, int32 metadata, int8 pools and f32
    scales, 16-byte aligned q and pools, D a multiple of 8 up to 256."""
    d = q.shape[-1]
    for x in floats + ints + quant:
        if x.device != q.device:
            raise ValueError(f"operands on {x.device} and {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} needs contiguous operands")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if any(x.dtype != q.dtype for x in floats):
        raise TypeError(f"pools {floats[1].dtype}/{floats[2].dtype} must "
                        f"match q {q.dtype}")
    if any(x.dtype != torch.int32 for x in ints):
        raise TypeError("block tables, context lengths and tile metadata "
                        "must be int32")
    if quant and (quant[0].dtype != torch.int8 or quant[1].dtype != torch.int8
                  or quant[2].dtype != torch.float32
                  or quant[3].dtype != torch.float32):
        raise TypeError("int8 pools must be int8 and their scales float32")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d} must be a multiple of 8, <= 256")
    if any(x.data_ptr() % 16 for x in floats + quant[:2]):
        raise ValueError("q and pools must be 16-byte aligned")


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.ptt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({msg})")


def _check_smem(smem: int, what: str) -> None:
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{what} needs {smem} B of shared memory per CTA, "
                         f"over the card's {_MAX_SMEM_BYTES}")


def _launch(q, k_pool, v_pool, ints, num_tiles: int, scale: float,
            quant=()) -> torch.Tensor:
    """One call of the kernel pair: kernel 1 (fp pools; `ints` the five
    ragged metadata arrays), kernel 2 (the same with `quant` = (kq, vq,
    k_scales, v_scales): bias-encoded tables over fp + int8 pools), or
    kernel 3 (`ints` = (block_tables, context_lens): the decode packing,
    one tile a sequence)."""
    decode = len(ints) == 2
    name = "paged_attention" if decode else "ragged_paged_attention"
    t, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    tq = t // num_tiles
    _check_launch(name, q, (q, k_pool, v_pool), ints, quant)
    mb = ints[0].shape[1]
    plan = ragged_plan(q.dtype, num_tiles, tq, h, hkv, d, bs, mb)
    sched = plan.schedule
    _check_smem(sched.smem_bytes, f"tile_q={tq} x groups={h // hkv} x "
                                  f"head_dim={d} in {q.dtype}")
    lib = _library()
    out = torch.empty_like(q)
    # the splits' partials; with one split every tile writes its output
    ws = (None if plan.workspace is None else
          torch.empty(plan.workspace, dtype=torch.float32, device=q.device))
    shape = (num_tiles,) + (() if decode else (tq,)) + (
        h, hkv, d, bs, mb, sched.chunk, sched.split, float(scale),
        _DTYPE_CODES[q.dtype])
    fn = (lib.ptt_paged_attention if decode
          else lib.ptt_ragged_paged_attention_mixed if quant
          else lib.ptt_ragged_paged_attention)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*[x.data_ptr() for x in (q, k_pool, v_pool, *quant, *ints,
                                         out)],
                None if ws is None else ws.data_ptr(), *shape, stream)
    _raise_on(lib, rc, name)
    if decode:
        paged_attention.launches += 1
    elif quant:
        ragged_paged_attention.mixed_launches += 1
    else:
        ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                           q_starts, tile_rows, tile_offs,
                           scale: Optional[float] = None,
                           kq_pool=None, vq_pool=None,
                           k_scales=None, v_scales=None,
                           check_block_ids: bool = False):
    """Mixed prefill+decode attention over the flat ragged packing — the
    engine's single-step entry point. Dispatch is by the tensors'
    device: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (launched or raised, never replaced).

    With the int8 pools (kq_pool/vq_pool [NQ, BS, Hkv, D] int8,
    k_scales/v_scales [NQ] f32) the table is bias-encoded and the mixed
    kernel reads int8 blocks in place; the call's shapes are the same
    whether a batch is fp-only, mixed or all-int8. `check_block_ids` is
    the debug check that every id lies in [-NQ, NB): a CUDA kernel would
    read garbage where JAX clamps (it syncs with the device)."""
    _check_operands(q, k_pool, v_pool, block_tables, context_lens, q_starts,
                    tile_rows, tile_offs)
    quant = ()
    if kq_pool is not None or k_scales is not None:
        _check_quant_operands(k_pool, kq_pool, vq_pool, k_scales, v_scales)
        quant = (kq_pool, vq_pool, k_scales, v_scales)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if check_block_ids:
        _check_block_ids(block_tables, k_pool.shape[0],
                         kq_pool.shape[0] if quant else 0)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pool, v_pool, block_tables, context_lens, q_starts,
            tile_rows, tile_offs, scale, kq_pool, vq_pool, k_scales,
            v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged_paged_attention for device {q.device}")
    return _launch(q, k_pool, v_pool, (block_tables, context_lens, q_starts,
                                       tile_rows, tile_offs),
                   tile_rows.shape[0], scale, quant)


# kernel launches since the last reset (set to 0 to reset): `launches`
# counts kernel 1 (fp pools), `mixed_launches` kernel 2 (int8 pools
# given), one a call although a call runs the split kernel and, with
# more than one split, the combine kernel; the plain version on CPU
# tensors counts in neither. Under CUDA-graph capture a call launches
# nothing: CapturedLaunches (below) counts it at each replay instead
ragged_paged_attention.launches = 0
ragged_paged_attention.mixed_launches = 0


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    scale: Optional[float] = None,
                    check_block_ids: bool = False):
    """Single-token decode attention over block tables — the split
    path's decode entry point (`MultiHeadAttention.decode_paged`).
    q: [B, H, D]; pools [NB, BS, Hkv, D]; block_tables [B, MB] int32;
    context_lens [B] int32 (tokens visible to each row, this one
    included). Returns [B, H, D]. Dispatch by device as
    `ragged_paged_attention`. On the card a row at context 0 gives zeros
    (the Pallas kernel's acc / max(l, 1e-30)), and a context past the
    table's MB * BS positions sees those positions; the plain version
    gives what JAX's reference gives."""
    if (q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape
            or k_pool.shape[3] != q.shape[2]):
        raise ValueError(
            f"expected q [B, H, D] and pools [NB, BS, Hkv, D]; got q "
            f"{tuple(q.shape)}, pools {tuple(k_pool.shape)}/"
            f"{tuple(v_pool.shape)}")
    b, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    if (block_tables.dim() != 2 or block_tables.shape[0] != b
            or context_lens.shape != (b,)):
        raise ValueError("expected block_tables [B, MB], context_lens [B]")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if check_block_ids:
        _check_block_ids(block_tables, nb)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         context_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention for device {q.device}")
    return _launch(q, k_pool, v_pool, (block_tables, context_lens), b, scale)


# kernel-3 launches since the last reset (set to 0 to reset): one a call
# although a call runs the split kernel and, with more than one split,
# the combine kernel; the plain version on CPU tensors does not count
paged_attention.launches = 0

# every counter above, as (wrapper, attribute)
LAUNCH_COUNTERS = ((ragged_paged_attention, "launches"),
                   (ragged_paged_attention, "mixed_launches"),
                   (paged_attention, "launches"))


class CapturedLaunches:
    """Launch accounting of a captured CUDA graph. A wrapper counts a
    launch when it runs on the host, and under capture that records its
    kernel into the graph without launching it; each replay launches it.
    `capture(record, warm_up)` runs the warm-up (real launches, set-up
    that is not counted) and then `record` (the capture), notes how far
    `record` raised each counter, and puts every counter back; `replay()`
    adds that rise, once a replay. `counters` are (object, attribute)
    pairs, by default this module's; any captured callable can pass its
    wrappers' own."""

    def __init__(self, counters=LAUNCH_COUNTERS):
        self.counters = tuple(counters)
        self.per_replay = (0,) * len(self.counters)

    def _read(self) -> tuple:
        return tuple(getattr(obj, attr) for obj, attr in self.counters)

    def _write(self, values) -> None:
        for (obj, attr), value in zip(self.counters, values):
            setattr(obj, attr, value)

    def capture(self, record, warm_up=None):
        """Returns what `record()` returns."""
        start = self._read()
        try:
            if warm_up is not None:
                warm_up()
            before = self._read()
            out = record()
            self.per_replay = tuple(
                a - b for a, b in zip(self._read(), before))
        finally:
            self._write(start)
        return out

    def replay(self) -> None:
        self._write(tuple(v + n for v, n in
                          zip(self._read(), self.per_replay)))
