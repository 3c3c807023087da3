#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # on the machine with the card
    python3 chip_smoke.py --tiny     # rehearsal on the CPU, plain versions

Builds every CUDA kernel of the port from the sources in this checkout,
holds each kernel against its plain PyTorch version at its path's
shapes, times it, and then drives the port's paths at the repo's LM
configuration (LM_BASE/LM_VOCAB of paddle_tpu/benchmark/models.py:
vocab 32000, d 512, 8 heads, 6 layers, ffn 2048, tied head, max_len
2048) with random weights made from a seed, through the entry points a
user calls:

- `engine`: a `ServeEngine` (bf16) serving two waves that share a
  prefix — the fp ragged kernel;
- `engine_int8`: `ServeEngine.from_saved_model` over a v2 export of the
  same weights with the in-device int8 KV tier on: the shared prefix
  is quantized while fillers run, and the second wave reads it in
  place — the mixed ragged kernel;
- `split_path`: `CausalLM.prefill_chunk_paged` then
  `decode_step_paged` — the paged-decode kernel.

Each kernel's launch count is set to 0 just before its path runs and
read just after. Each phase prints one JSON line; any failed check
raises and the script exits non-zero. The line before the last lists
the kernels; the last line is `{"ok": true, "device": {...}}`.

Without a CUDA card (and without --tiny) it exits non-zero and prints
no result. Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.engine import ServeEngine
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.testing import (PAGED_ARGS, QUANT_ARGS, RAGGED_ARGS,
                                      STEP_ARGS, causal_lm_tree,
                                      int8_blocks, pack_prompts, paged_case,
                                      ragged_case, write_serving_export)

# the repo's LM configuration (paddle_tpu/benchmark/models.py:150-152)
LM_BASE = dict(model_dim=512, num_heads=8, num_layers=6, ffn_dim=2048,
               dropout=0.0)
LM_VOCAB = 32000
LM_MAX_LEN = 2048

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; dense bf16 FLOP/s on
# the tensor cores and float32 FLOP/s outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SEED = 1234
# where the engine_int8 phase writes its export (git-ignored build/)
EXPORT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_export"

KERNEL_ROWS = {
    # name: (source, the TPU kernel it replaces, library_ms note)
    "ragged_paged_attention": (
        "paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu",
        "paddle_tpu/kernels/paged_attention.py:428",
        "no single PyTorch call computes a block-table-gathered ragged "
        "attention"),
    "ragged_paged_attention_mixed": (
        "paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu",
        "paddle_tpu/kernels/paged_attention.py:462",
        "no single PyTorch call reads int8 blocks through a bias-encoded "
        "table"),
    "paged_attention": (
        "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        "paddle_tpu/kernels/paged_attention.py:173",
        "no single PyTorch call gathers K/V through block tables; "
        "scaled_dot_product_attention needs the K/V gathered dense first"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# -- operands -----------------------------------------------------------

def _to_device(case, dtype: torch.dtype, device: torch.device,
               keys=RAGGED_ARGS) -> List[torch.Tensor]:
    """The case's arrays on `device`, q and pools in `dtype`."""
    return [torch.from_numpy(case[k]).to(device=device, dtype=dtype)
            if k in ("q", "k_pool", "v_pool")
            else torch.from_numpy(case[k]).to(device) for k in keys]


def ragged_args(rows: Sequence[Tuple[int, int]], h: int, hkv: int, d: int,
                bs: int, tq: int, num_blocks: int, mb: int, pad_tiles: int,
                dtype: torch.dtype, device: torch.device,
                seed: int) -> List[torch.Tensor]:
    """ragged_paged_attention's operands on `device` (testing.ragged_case:
    (context_len, q_len) rows, shuffled block ids, the null row behind
    the pad tiles); q and pools in `dtype`."""
    case = ragged_case(rows, h, hkv, d, bs, tq, num_blocks, mb, pad_tiles,
                       seed)
    return _to_device(case, dtype, device)


def mixed_args(rows: Sequence[Tuple[int, int]], h: int, hkv: int, d: int,
               bs: int, tq: int, num_blocks: int, mb: int, pad_tiles: int,
               dtype: torch.dtype, device: torch.device, seed: int,
               which) -> Tuple[list, dict, list, int]:
    """As ragged_args, with the blocks `which` picks moved into int8
    slots by the port's quantize_block (testing.int8_blocks): returns
    (args over a bias-encoded table, int8 kwargs, args over pools into
    which those blocks were promoted with dequantize_block, int8 block
    count)."""
    case = ragged_case(rows, h, hkv, d, bs, tq, num_blocks, mb, pad_tiles,
                       seed)
    mixed, promoted, n8 = int8_blocks(case, which, dtype)
    quant = dict(zip(QUANT_ARGS, _to_device(mixed, dtype, device,
                                            QUANT_ARGS)))
    return (_to_device(mixed, dtype, device), quant,
            _to_device(promoted, dtype, device), n8)


def kv_bytes(table: np.ndarray, lens: np.ndarray, bs: int, hkv: int,
             d: int, elem_bytes: int) -> int:
    """Bytes of the K/V blocks the rows read, each block once: an fp
    block 2 * BS * Hkv * D * elem bytes; an int8 one (negative id)
    1 byte per element plus 4 bytes of scale, for K and for V."""
    blocks = set()
    for row in range(table.shape[0]):
        blocks.update(table[row, :-(-int(lens[row]) // bs)].tolist())
    n8 = sum(1 for b in blocks if b < 0)
    per = bs * hkv * d
    return (2 * (len(blocks) - n8) * per * elem_bytes
            + 2 * n8 * (per + 4))


def step_cost(args, elem_bytes: int) -> Tuple[float, float]:
    """(bytes, FLOPs) a ragged step must at least move and do on these
    inputs, counting real query tokens only (not a tile's pad slots past
    its row's q_len, nor the pad tiles on the null row, the last row of
    testing.ragged_case): their q read and out written once, every K/V
    block a real row needs read once (int8 blocks at their own size), the
    int32 metadata; 4*D FLOPs per (query head, visible kv position)."""
    q, k_pool, _, bt, cl, qs, tr, to = [a.cpu() for a in args]
    t, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    tq = t // tr.shape[0]
    null = bt.shape[0] - 1
    tokens = flops = 0
    for tile in range(tr.shape[0]):
        row = int(tr[tile])
        if row == null:
            continue
        q0 = int(qs[row]) + int(to[tile])
        n = min(tq, int(cl[row]) - q0)    # real queries of this tile
        tokens += n
        # query q0 + i sees positions 0..q0 + i (all < ctx)
        flops += 4 * h * d * sum(q0 + i + 1 for i in range(n))
    meta = sum(a.numel() * 4 for a in (bt, cl, qs, tr, to))
    nbytes = (2 * tokens * h * d * elem_bytes + meta
              + kv_bytes(bt[:null].numpy(), cl[:null].numpy(), bs, hkv, d,
                         elem_bytes))
    return float(nbytes), float(flops)


def decode_cost(args, elem_bytes: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one paged decode call, every row a real query:
    q read and out written once, each row's blocks up to its context
    once, the metadata; 4*D FLOPs per (head, visible kv position)."""
    q, k_pool, _, bt, cl = [a.cpu() for a in args]
    b, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    nbytes = (2 * b * h * d * elem_bytes + 4 * (bt.numel() + cl.numel())
              + kv_bytes(bt.numpy(), cl.numpy(), bs, hkv, d, elem_bytes))
    return float(nbytes), float(4 * h * d * int(cl.long().sum()))


def bound(nbytes: float, flops: float,
          dtype: torch.dtype) -> Tuple[float, float, float]:
    """The least time, ms, for this work on the card by bytes (over HBM
    bandwidth) and by operations (over the peak rate of the inputs'
    type): returns (bytes ms, operations ms, the larger of the two)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return t_bytes, t_ops, max(t_bytes, t_ops)


def time_ms(fn, iters: int, warmup: int, cuda: bool) -> float:
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


# -- phases -------------------------------------------------------------

def phase_device(cuda: bool) -> dict:
    if not cuda:
        emit({"phase": "device", "kind": "cpu", "rehearsal": True})
        return {"kind": "cpu", "count": 0, "smi": "not measured"}
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return {"kind": kind, "count": torch.cuda.device_count(), "smi": smi}


def phase_build(cfg: dict, cuda: bool) -> None:
    """Build every kernel from this checkout's sources (one nvcc per
    source, in parallel); report ptxas's registers/spills and the
    dynamic shared memory a CTA takes at the serving paths' shapes."""
    if not cuda:
        emit({"phase": "build", "skipped": "no nvcc in a CPU rehearsal"})
        return
    t0 = time.perf_counter()
    infos = build.build_all()
    seconds = time.perf_counter() - t0
    d, bs, h = cfg["head_dim"], cfg["block_size"], cfg["num_heads"]
    emit({"phase": "build", "seconds": round(seconds, 3),
          "kernels": {n: {"library": str(i.path.name),
                          "nvcc_seconds": round(i.seconds, 3),
                          "ptxas": build.ptxas_report(n).splitlines()}
                      for n, i in infos.items()},
          "ragged_paged_attention_dynamic_smem_bytes":
              paged.shared_memory_bytes(cfg["tile_q"], 1, d, bs),
          "paged_attention_dynamic_smem_bytes_gqa":
              paged.shared_memory_bytes(1, h // cfg["gqa_kv_heads"], d, bs,
                                        "paged_attention")})


def _plain(args):
    return [a.float() if a.is_floating_point() else a for a in args]


def _check_close(kernel: str, got, plain, atol: float, **info) -> float:
    err = float((got.float() - plain).abs().max())
    emit({"phase": "kernel_vs_plain", "kernel": kernel, **info,
          "max_abs_err": err, "atol": atol, "ok": err <= atol})
    check(bool(torch.isfinite(got).all()), f"{kernel}: non-finite output")
    check(err <= atol, f"{kernel} vs plain: {err} > {atol} ({info})")
    return err


def phase_kernel_vs_plain(cfg: dict, device: torch.device) -> dict:
    """Each kernel against its plain version, MHA and GQA 8:2, f32
    against the plain version in f32 (atol 1e-4) and bf16 against the
    plain version in f32 on the same bf16 values (atol 2e-2):
    - ragged fp and mixed: decode rows, a chunk from block-aligned
      position 96, one from off-stride 213, a whole prompt, pad tiles
      and the null row; the mixed table holds int8 ids at odd table
      positions and fp ids elsewhere;
    - paged decode: contexts from 1 to 1200, ends off the block grid.
    Returns the worst error per kernel."""
    bs, tq, d, h = cfg["block_size"], cfg["tile_q"], cfg["head_dim"], \
        cfg["num_heads"]
    worst: Dict[str, float] = dict.fromkeys(KERNEL_ROWS, 0.0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    for hkv in (h, cfg["gqa_kv_heads"]):
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            info = dict(heads=h, kv_heads=hkv,
                        dtype=str(dtype).replace("torch.", ""))
            geom = (cfg["check_rows"], h, hkv, d, bs, tq,
                    cfg["check_blocks"], cfg["max_blocks"], 2, dtype, device,
                    SEED)
            args = ragged_args(*geom)
            got = paged.ragged_paged_attention(*args)
            sync()
            worst["ragged_paged_attention"] = max(
                worst["ragged_paged_attention"], _check_close(
                    "ragged_paged_attention", got,
                    paged.ragged_paged_attention_reference(*_plain(args)),
                    atol, tokens=int(args[0].shape[0]), **info))
            margs, quant, _, n8 = mixed_args(*geom, "odd")
            got = paged.ragged_paged_attention(*margs, **quant,
                                               check_block_ids=True)
            sync()
            worst["ragged_paged_attention_mixed"] = max(
                worst["ragged_paged_attention_mixed"], _check_close(
                    "ragged_paged_attention_mixed", got,
                    paged.ragged_paged_attention_reference(
                        *_plain(margs), **quant),
                    atol, int8_blocks=n8, **info))
            case = paged_case(cfg["paged_check_lens"], h, hkv, d, bs,
                              cfg["check_blocks"], cfg["max_blocks"], SEED)
            pargs = _to_device(case, dtype, device, PAGED_ARGS)
            got = paged.paged_attention(*pargs, check_block_ids=True)
            sync()
            worst["paged_attention"] = max(
                worst["paged_attention"], _check_close(
                    "paged_attention", got,
                    paged.paged_attention_reference(*_plain(pargs)), atol,
                    contexts=cfg["paged_check_lens"], **info))
    return worst


def phase_mixed_vs_promote(cfg: dict, device: torch.device) -> None:
    """The direct read's invariant on the card: the mixed kernel over a
    bias-encoded table gives, byte for byte, the fp kernel's output over
    pools into which the same blocks were promoted with the port's
    dequantize_block."""
    bs, tq, d, h = cfg["block_size"], cfg["tile_q"], cfg["head_dim"], \
        cfg["num_heads"]
    for hkv in (h, cfg["gqa_kv_heads"]):
        for dtype in (torch.float32, torch.bfloat16):
            margs, quant, pargs, n8 = mixed_args(
                cfg["check_rows"], h, hkv, d, bs, tq, cfg["check_blocks"],
                cfg["max_blocks"], 2, dtype, device, SEED + 5, "odd")
            direct = paged.ragged_paged_attention(*margs, **quant)
            promoted = paged.ragged_paged_attention(*pargs)
            equal = bool(torch.equal(direct, promoted))
            emit({"phase": "mixed_vs_promote", "kv_heads": hkv,
                  "dtype": str(dtype).replace("torch.", ""),
                  "int8_blocks": n8, "bit_equal": equal})
            check(equal, f"direct int8 read != promote-then-fp-kernel "
                         f"(hkv={hkv}, {dtype})")


def _timed(name: str, launch, plain, cost, dtype, cfg: dict, cuda: bool,
           card: dict, **info) -> dict:
    ms = time_ms(launch, cfg["time_iters"], 10, cuda)
    plain_ms = time_ms(plain, cfg["plain_iters"], 2, cuda)
    nbytes, flops = cost
    bytes_ms, ops_ms, bound_ms = bound(nbytes, flops, dtype)
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms,
           "library_ms": None, "bytes": nbytes, "flops": flops}
    emit({"phase": "kernel_time", "kernel": name,
          "dtype": str(dtype).replace("torch.", ""), **info,
          "device": card["kind"], "nvidia_smi": card["smi"], **out,
          "note": f"library_ms null: {KERNEL_ROWS[name][2]}"})
    return out


def phase_kernel_time(cfg: dict, device: torch.device, card: dict) -> dict:
    """Each kernel, its plain version and its bound at its path's
    busiest shape. Launches cycle over one pool copy per model layer,
    as a step does, so the 50 MB L2 cache does not hold one launch's
    K/V blocks for the next.
    - ragged (fp, bf16 as the engine phase) and mixed (f32 as the
      engine_int8 phase serves, and bf16): the engine's busiest step,
      a 456-token chunk from 256 plus 7 decode rows; for the mixed
      kernel every other block before each row's query window is
      int8-resident (even table positions);
    - paged decode (f32 as the split_path phase, and bf16): 8 decode
      rows at contexts 300-1200.
    Returns {kernel: timing in its path's dtype}."""
    cuda = device.type == "cuda"
    h, d, bs = cfg["num_heads"], cfg["head_dim"], cfg["block_size"]
    layers = cfg["lm"]["num_layers"]

    def cycle(pools):
        return itertools.cycle(
            [pools] + [tuple(p.clone() for p in pools)
                       for _ in range(layers - 1)])

    def half_prefix(row: int, j: int, q_start: int) -> bool:
        return (j + 1) * bs <= q_start and j % 2 == 0

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        geom = (cfg["time_rows"], h, h, d, bs, cfg["tile_q"],
                cfg["num_blocks"], cfg["max_blocks"], cfg["time_pad_tiles"],
                dtype, device, SEED + 1)
        args = ragged_args(*geom)
        q, meta = args[0], args[3:]
        info = dict(tokens=int(q.shape[0]), rows=len(cfg["time_rows"]))
        if dtype == torch.bfloat16:
            pools = cycle((args[1], args[2]))
            out["ragged_paged_attention"] = _timed(
                "ragged_paged_attention",
                lambda: paged.ragged_paged_attention(q, *next(pools), *meta),
                lambda: paged.ragged_paged_attention_reference(
                    q, *next(pools), *meta),
                step_cost(args, q.element_size()), dtype, cfg, cuda, card,
                **info)
        margs, quant, _, n8 = mixed_args(*geom, half_prefix)
        mmeta = margs[3:]
        mpools = cycle((margs[1], margs[2], quant["kq_pool"],
                        quant["vq_pool"]))

        def mixed(fn):
            k, v, kq, vq = next(mpools)
            return fn(q, k, v, *mmeta, kq_pool=kq, vq_pool=vq,
                      k_scales=quant["k_scales"],
                      v_scales=quant["v_scales"])
        timing = _timed(
            "ragged_paged_attention_mixed",
            lambda: mixed(paged.ragged_paged_attention),
            lambda: mixed(paged.ragged_paged_attention_reference),
            step_cost(margs, q.element_size()), dtype, cfg, cuda, card,
            int8_blocks=n8, **info)
        if dtype == torch.float32:
            out["ragged_paged_attention_mixed"] = timing
        case = paged_case(cfg["paged_time_lens"], h, h, d, bs,
                          cfg["num_blocks"], cfg["max_blocks"], SEED + 6)
        pargs = _to_device(case, dtype, device, PAGED_ARGS)
        ppools = cycle((pargs[1], pargs[2]))
        timing = _timed(
            "paged_attention",
            lambda: paged.paged_attention(pargs[0], *next(ppools),
                                          *pargs[3:]),
            lambda: paged.paged_attention_reference(pargs[0], *next(ppools),
                                                    *pargs[3:]),
            decode_cost(pargs, pargs[0].element_size()), dtype, cfg, cuda,
            card, rows=len(cfg["paged_time_lens"]),
            contexts=cfg["paged_time_lens"])
        if dtype == torch.float32:
            out["paged_attention"] = timing
    return out


def phase_step_vs_dense(cfg: dict, tree: dict, device: torch.device) -> None:
    """The model's serve step (kernel attention, f32) against its dense
    forward (plain attention) on the same prompts at full width."""
    model = CausalLM(vocab=cfg["vocab"], max_len=cfg["max_len"],
                     dtype=torch.float32, device=device, **cfg["lm"])
    load_jax_params(model, tree)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg["vocab"], n).tolist() for n in (40, 23)]
    packed, used = pack_prompts(prompts, cfg["block_size"], cfg["tile_q"],
                                cfg["max_blocks"])
    ops = [torch.from_numpy(packed[k]).to(device) for k in STEP_ARGS]
    attn = model.blocks[0].attn
    shape = (used, cfg["block_size"], attn.num_kv_heads, attn.head_dim)
    pools = [(torch.zeros(shape, device=device),
              torch.zeros(shape, device=device)) for _ in model.blocks]
    with torch.inference_mode():
        step = model.ragged_step_paged(ops[0], ops[1], pools, *ops[2:])
        dense = torch.stack([model(torch.tensor([p], device=device))[0, -1]
                             for p in prompts])
    err = float((step - dense).abs().max())
    emit({"phase": "step_vs_dense", "dtype": "float32",
          "logits": list(step.shape), "max_abs_err": err, "atol": 1e-3})
    check(bool(torch.isfinite(step).all()), "non-finite step logits")
    check(err <= 1e-3, f"serve step vs dense forward: {err} > 1e-3")


def _reset_launches() -> None:
    paged.ragged_paged_attention.launches = 0
    paged.ragged_paged_attention.mixed_launches = 0
    paged.paged_attention.launches = 0


def _launches() -> Dict[str, int]:
    return {"ragged_paged_attention": paged.ragged_paged_attention.launches,
            "ragged_paged_attention_mixed":
                paged.ragged_paged_attention.mixed_launches,
            "paged_attention": paged.paged_attention.launches}


def _expect_launches(kernel: str, steps: int, layers: int,
                     cuda: bool) -> Dict[str, int]:
    """After a path's run: `kernel` launched once per layer per step and
    no other kernel launched (on the CPU nothing launches)."""
    got = _launches()
    want = dict.fromkeys(got, 0)
    if cuda:
        want[kernel] = steps * layers
    check(got == want, f"kernel launches {got} != {want} ({steps} steps "
                       f"x {layers} layers through {kernel})")
    return got


def phase_engine(cfg: dict, tree: dict, device: torch.device,
                 card: dict) -> dict:
    """The fp path: a ServeEngine at full width serving two waves of
    requests that share a system prefix."""
    cuda = device.type == "cuda"
    model = CausalLM(vocab=cfg["vocab"], max_len=cfg["max_len"],
                     dtype=cfg["dtype"], device=device, **cfg["lm"])
    load_jax_params(model, tree)
    engine_kw = dict(block_size=cfg["block_size"],
                     num_blocks=cfg["num_blocks"],
                     max_batch_size=cfg["max_batch"],
                     max_prefill_tokens=cfg["max_prefill"],
                     tile_q=cfg["tile_q"], device=device)
    n_new = cfg["max_new"]
    # warm-up (cuBLAS handles, allocator) on a throwaway engine
    ServeEngine(model, **engine_kw).generate([[1, 2, 3]], max_new_tokens=2)

    rng = np.random.default_rng(SEED + 3)
    vocab = cfg["vocab"]
    prefix = rng.integers(0, vocab, cfg["prefix"]).tolist()
    lens1 = [cfg["long_prompt"] - cfg["prefix"]] + [
        16 + 9 * i for i in range(cfg["max_batch"] - 1)]
    wave1 = [prefix + rng.integers(0, vocab, n).tolist() for n in lens1]
    wave2 = [prefix + rng.integers(0, vocab, 5 + 7 * i).tolist()
             for i in range(cfg["max_batch"])]

    engine = ServeEngine(model, **engine_kw)
    _reset_launches()                               # the path's counts
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs1 = [engine.add_request(p, max_new_tokens=n_new) for p in wave1]
    engine.run()
    reqs2 = [engine.add_request(p, max_new_tokens=n_new) for p in wave2]
    engine.run()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    layers = len(model.blocks)
    launches = _expect_launches("ragged_paged_attention", engine.steps,
                                layers, cuda)
    peak = torch.cuda.max_memory_allocated() if cuda else None

    reqs = reqs1 + reqs2
    for r in reqs:
        check(r.finish_reason == "length" and len(r.generated) == n_new,
              f"request {r.req_id} ended {r.finish_reason!r} after "
              f"{len(r.generated)} tokens")
    stats = engine.stats()
    check(stats["hit_tokens"] > 0, "second wave missed the prefix cache")
    check(len(engine.step_shapes) == 1,
          f"{len(engine.step_shapes)} step shapes (want 1)")
    engine.cache.assert_quiesced()

    # batched == solo: the long wave-1 request and a wave-2 prefix hit
    # run alone on fresh engines must give the same streams
    solo_ok = []
    for r in (reqs1[0], reqs2[-1]):
        alone = ServeEngine(model, **engine_kw).generate(
            [r.prompt], max_new_tokens=n_new)[0]
        solo_ok.append(alone == r.generated)
    check(all(solo_ok), f"batched != solo streams: {solo_ok}")

    ttft = sorted((r.first_token_time - r.enqueue_time) * 1e3 for r in reqs)
    out = {"steps": engine.steps, "requests": len(reqs),
           "generated_tokens": n_new * len(reqs), "wall_s": wall,
           "tokens_per_s": n_new * len(reqs) / wall,
           "ttft_p50_ms": float(np.median(ttft)),
           "peak_bytes": peak, "kernel_launches": launches,
           "layers": layers, "hit_tokens": stats["hit_tokens"],
           "prompt_tokens": stats["prompt_tokens"],
           "batched_equals_solo": True, "device": card["kind"],
           "nvidia_smi": card["smi"]}
    emit({"phase": "engine", **out})
    return out


def phase_engine_int8(cfg: dict, tree: dict, device: torch.device,
                      card: dict) -> dict:
    """The int8-tier path, through `ServeEngine.from_saved_model` over a
    v2 export of the seeded weights (the JAX export's layout, written
    with numpy; the engine builds the model in float32, as the JAX
    engine does). Wave 1 shares a prefix; filler waves run while the
    prefix idles past the quantize sweep's idle steps, until the pool
    has recycled the prefix's fp blocks; wave 2 hits the int8-resident
    prefix and reads it in place. Checks: direct reads > 0 and no
    promotion; the same traffic with kv_promote_hits=1 gives the same
    greedy streams; batched == solo (a wave-2 request replayed alone on
    an engine brought to the same state); one step shape; one mixed
    launch per layer per step and no fp-kernel launch."""
    cuda = device.type == "cuda"
    c = cfg["int8"]
    lm = cfg["lm"]
    # the manifest's serve block, as engine.serve_metadata writes it
    meta = {"model_type": "causal_lm", "vocab": cfg["vocab"],
            "model_dim": lm["model_dim"], "num_heads": lm["num_heads"],
            "num_kv_heads": lm["num_heads"],
            "head_dim": lm["model_dim"] // lm["num_heads"],
            "num_layers": lm["num_layers"], "ffn_dim": lm["ffn_dim"],
            "max_len": cfg["max_len"], "tie_embeddings": True,
            "fused_qkv": False}
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    write_serving_export(str(EXPORT_DIR), tree, meta)
    engine_kw = dict(block_size=cfg["block_size"],
                     num_blocks=c["num_blocks"],
                     max_batch_size=cfg["max_batch"],
                     max_prefill_tokens=cfg["max_prefill"],
                     tile_q=cfg["tile_q"],
                     kv_compress_blocks=c["compress_blocks"])
    rng = np.random.default_rng(SEED + 7)
    vocab, n_new, bs = cfg["vocab"], c["max_new"], cfg["block_size"]
    prefix = rng.integers(0, vocab, cfg["prefix"]).tolist()
    wave1 = [prefix + rng.integers(0, vocab, 16 + 9 * i).tolist()
             for i in range(cfg["max_batch"])]
    wave2 = [prefix + rng.integers(0, vocab, 5 + 7 * i).tolist()
             for i in range(cfg["max_batch"])]
    fillers = [[rng.integers(0, vocab, c["filler_len"]).tolist()
                for _ in range(cfg["max_batch"])]
               for _ in range(c["max_filler_waves"])]
    head = tuple(prefix[:bs])

    def serve(promote_hits: int, only=None, fill_waves=None):
        """A fresh engine from the export; wave 1, fillers, then wave 2
        (or just the wave-2 prompt `only`). Returns (engine, wave-2
        requests, filler waves run, wave-2 seconds)."""
        eng = ServeEngine.from_saved_model(
            str(EXPORT_DIR), device=device, kv_promote_hits=promote_hits,
            **engine_kw)
        eng.generate(wave1, max_new_tokens=n_new)
        waves = 0
        while (head in eng.cache._index if fill_waves is None
               else waves < fill_waves):
            check(waves < len(fillers), "fillers never recycled the "
                                        "prefix's fp blocks")
            eng.generate(fillers[waves], max_new_tokens=4)
            waves += 1
        check(head not in eng.cache._index and head in eng.cache._cindex,
              "the prefix is not int8-resident only before wave 2")
        t0 = time.perf_counter()
        reqs = [eng.add_request(p, max_new_tokens=n_new)
                for p in ([only] if only else wave2)]
        eng.run()
        if cuda:
            torch.cuda.synchronize()
        return eng, reqs, waves, time.perf_counter() - t0

    serve(0, only=wave2[0])                        # warm-up
    _reset_launches()                               # the path's counts
    t0 = time.perf_counter()
    engine, reqs, waves, wave2_s = serve(0)
    wall = time.perf_counter() - t0
    layers = lm["num_layers"]
    launches = _expect_launches("ragged_paged_attention_mixed",
                                engine.steps, layers, cuda)
    st = engine.stats()
    streams = [r.generated for r in reqs]
    for r in reqs:
        check(r.finish_reason == "length" and len(r.generated) == n_new,
              f"request {r.req_id} ended {r.finish_reason!r}")
    check(st["direct_int8_reads"] > 0, "wave 2 read no int8 block")
    check(st["promote_total"] == 0, f"{st['promote_total']} promotions "
                                    "with kv_promote_hits=0")
    check(len(engine.step_shapes) == 1,
          f"{len(engine.step_shapes)} step shapes (want 1)")
    engine.cache.assert_quiesced()

    promote, preqs, _, promote_s = serve(1, fill_waves=waves)
    pst = promote.stats()
    check(pst["promote_total"] > 0 and pst["direct_int8_reads"] == 0,
          "kv_promote_hits=1 did not promote")
    same = [r.generated for r in preqs] == streams
    check(same, "direct-read streams != promote streams")
    solo_ok = []
    for i in (0, len(wave2) - 1):
        _, alone, _, _ = serve(0, only=wave2[i], fill_waves=waves)
        solo_ok.append(alone[0].generated == streams[i])
    check(all(solo_ok), f"batched != solo streams: {solo_ok}")

    ttft = sorted((r.first_token_time - r.enqueue_time) * 1e3 for r in reqs)
    pttft = sorted((r.first_token_time - r.enqueue_time) * 1e3
                   for r in preqs)
    out = {"steps": engine.steps, "kernel_launches": launches,
           "layers": layers, "dtype": "float32",
           "filler_waves": waves, "wall_s": wall,
           "wave2_s": wave2_s, "wave2_s_promote": promote_s,
           "wave2_ttft_p50_ms": float(np.median(ttft)),
           "wave2_ttft_p50_ms_promote": float(np.median(pttft)),
           "direct_int8_reads": st["direct_int8_reads"],
           "compress_total": st["compress_total"],
           "compress_spills": st["compress_spills"],
           "compress_hit_tokens": st["compress_hit_tokens"],
           "promote_total_promote_run": pst["promote_total"],
           "effective_pool_bytes": engine.cache.effective_pool_bytes(),
           "streams_equal_promote": same, "batched_equals_solo": True,
           "device": card["kind"], "nvidia_smi": card["smi"]}
    emit({"phase": "engine_int8", **out})
    return out


def phase_split_path(cfg: dict, tree: dict, device: torch.device,
                     card: dict) -> dict:
    """The split prefill/decode path at full width in f32:
    prefill_chunk_paged over two prompts, then decode_step_paged steps
    feeding back the greedy tokens. Each step's logits must match the
    dense forward over the whole sequence (as step_vs_dense), and the
    paged-decode kernel must launch once per layer per decode step."""
    cuda = device.type == "cuda"
    model = CausalLM(vocab=cfg["vocab"], max_len=cfg["max_len"],
                     dtype=torch.float32, device=device, **cfg["lm"])
    load_jax_params(model, tree)
    rng = np.random.default_rng(SEED + 8)
    prompts = [rng.integers(0, cfg["vocab"], n).tolist()
               for n in cfg["split_prompts"]]
    steps, bs = cfg["split_steps"], cfg["block_size"]
    b, c = len(prompts), max(len(p) for p in prompts)
    mb = -(-(c + steps) // bs)
    tables = np.arange(1, 1 + b * mb, dtype=np.int32).reshape(b, mb)
    tokens = np.zeros((b, c), np.int32)
    slots = np.zeros((b, c), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        slots[i, :len(p)] = [tables[i, j // bs] * bs + j % bs
                             for j in range(len(p))]
    attn = model.blocks[0].attn
    shape = (1 + b * mb, bs, attn.num_kv_heads, attn.head_dim)
    pools = [(torch.zeros(shape, device=device),
              torch.zeros(shape, device=device)) for _ in model.blocks]
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=device)
    dev_tables = torch.from_numpy(tables).to(device)
    seqs = [list(p) for p in prompts]
    worst = 0.0
    _reset_launches()                               # the path's counts
    with torch.inference_mode():
        logits = model.prefill_chunk_paged(
            torch.from_numpy(tokens).to(device),
            torch.zeros(b, dtype=torch.int32, device=device), pools,
            dev_tables, lens, torch.from_numpy(slots.reshape(-1)).to(device),
            lens.long() - 1)
        for _ in range(steps):
            tok = logits.argmax(-1)
            pos = lens.clone()
            lens = lens + 1
            for i in range(b):
                seqs[i].append(int(tok[i]))
            dslots = torch.tensor(
                [int(tables[i, p // bs]) * bs + p % bs
                 for i, p in enumerate(pos.tolist())], device=device)
            logits = model.decode_step_paged(tok, pos, pools, dev_tables,
                                             lens, dslots)
            dense = torch.stack([model(torch.tensor([s], device=device))
                                 [0, -1] for s in seqs])
            worst = max(worst, float((logits - dense).abs().max()))
            check(bool(torch.isfinite(logits).all()),
                  "non-finite decode logits")
    if cuda:
        torch.cuda.synchronize()
    launches = _expect_launches("paged_attention", steps,
                                len(model.blocks), cuda)
    out = {"decode_steps": steps, "rows": b, "kernel_launches": launches,
           "layers": len(model.blocks), "dtype": "float32",
           "max_abs_err_vs_dense": worst, "atol": 1e-3,
           "device": card["kind"]}
    emit({"phase": "split_path", **out})
    check(worst <= 1e-3, f"split path vs dense forward: {worst} > 1e-3")
    return out


# -- configurations -------------------------------------------------------

def full_config() -> dict:
    return dict(
        lm=LM_BASE, vocab=LM_VOCAB, max_len=LM_MAX_LEN, dtype=torch.bfloat16,
        num_heads=8, head_dim=64, gqa_kv_heads=2, block_size=16, tile_q=8,
        num_blocks=1024, max_blocks=LM_MAX_LEN // 16, max_batch=8,
        max_prefill=512, max_new=32, prefix=256, long_prompt=1200,
        # (context_len, q_len): decode rows, a chunk from block-aligned
        # position 96, one from off-stride 213, a whole prompt
        check_rows=[(300, 1), (517, 1), (160, 64), (250, 37), (40, 40),
                    (1200, 1)],
        check_blocks=256,
        # paged decode contexts from 1 to 1200, ends off the block grid
        paged_check_lens=[1, 16, 17, 300, 517, 1200],
        # the engine's busiest step shape: a 456-token chunk from 256
        # plus 7 decode rows; 72 tiles = 576 flat tokens
        time_rows=[(712, 456)] + [(300 + 150 * i, 1) for i in range(7)],
        time_pad_tiles=8, time_iters=200, plain_iters=5,
        # 8 decode rows at contexts 300-1196
        paged_time_lens=[300 + 128 * i for i in range(8)],
        # engine_int8: a pool small enough that filler waves recycle the
        # prefix's fp blocks; an int8 pool above every block the run
        # compresses, so nothing spills
        int8=dict(num_blocks=256, compress_blocks=512, max_new=16,
                  filler_len=300, max_filler_waves=4),
        split_prompts=(40, 23), split_steps=4)


def tiny_config() -> dict:
    return dict(
        lm=dict(model_dim=64, num_heads=8, num_layers=2, ffn_dim=128,
                dropout=0.0),
        vocab=97, max_len=256, dtype=torch.float32, num_heads=8, head_dim=8,
        gqa_kv_heads=2, block_size=16, tile_q=8, num_blocks=64,
        max_blocks=16, max_batch=4, max_prefill=48, max_new=6, prefix=32,
        long_prompt=100,
        check_rows=[(30, 1), (47, 1), (48, 16), (45, 10), (9, 9)],
        check_blocks=32, paged_check_lens=[1, 16, 17, 45],
        time_rows=[(60, 40)] + [(20 + 5 * i, 1) for i in range(3)],
        time_pad_tiles=1, time_iters=3, plain_iters=2,
        paged_time_lens=[30, 45, 60, 75],
        int8=dict(num_blocks=24, compress_blocks=64, max_new=4,
                  filler_len=60, max_filler_waves=6),
        split_prompts=(20, 13), split_steps=3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="rehearse every phase on the CPU at a tiny size "
                         "with the plain versions")
    args = ap.parse_args(argv)
    cuda = not args.tiny
    if cuda and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); --tiny rehearses on the CPU", file=sys.stderr)
        return 2
    # the serve stream prints a JSON line per step; keep stdout to phases
    logging.getLogger("paddle_tpu_torch.serve").disabled = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if cuda else "cpu")
    cfg = full_config() if cuda else tiny_config()
    torch.manual_seed(SEED)

    card = phase_device(cuda)
    phase_build(cfg, cuda)
    errs = phase_kernel_vs_plain(cfg, device)
    phase_mixed_vs_promote(cfg, device)
    timing = phase_kernel_time(cfg, device, card)
    lm = cfg["lm"]
    tree = causal_lm_tree(SEED, cfg["vocab"], lm["model_dim"],
                          lm["num_heads"], lm["num_layers"], lm["ffn_dim"])
    phase_step_vs_dense(cfg, tree, device)
    paths = {"ragged_paged_attention": phase_engine(cfg, tree, device, card),
             "ragged_paged_attention_mixed": phase_engine_int8(
                 cfg, tree, device, card),
             "paged_attention": phase_split_path(cfg, tree, device, card)}

    rows = []
    for name, (source, replaces, _) in KERNEL_ROWS.items():
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": paths[name]["kernel_launches"][name],
            "launched": paths[name]["kernel_launches"][name],
            "checked": True, "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    emit({"kernels": rows})
    if cuda:
        emit({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                     "count": card["count"]}})
    else:
        emit({"ok": True, "rehearsal": True,
              "device": {"platform": "cpu", "kind": "cpu", "count": 0}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
