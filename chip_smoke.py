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

- `train`: a `Trainer` taking Adam steps on a bf16 `CausalLM` under the
  fused cross-entropy, B 4 x T 2048 — the flash forward, dq and dk/dv
  kernels (all three on the tensor cores in bf16); `train_profile`
  traces one more step for the card's busy time by kernel group;
  `train_vs_plain` holds one f32 step through the kernels against the
  same step through their plain versions;

- `engine`: a `ServeEngine` (bf16) serving two waves that share a
  prefix — the fp ragged kernel, inside the step's CUDA graph, which
  each engine captures once and replays every step (`graph_vs_eager`
  first holds that graph's logits to the eager step's, bit for bit);
  `serve_profile` traces one more wave for the card's busy time a step
  and its idle share;
- `engine_int8`: `ServeEngine.from_saved_model` over a v2 export of the
  same weights with the in-device int8 KV tier on: the shared prefix
  is quantized while fillers run, and the second wave reads it in
  place — the mixed ragged kernel;
- `engine_spec` (f32 and bf16): a `ServeEngine` with `spec_k=4` serving
  greedy requests whose prompts repeat a span, and two n-best groups —
  kernel 1 over decode windows of 1 + k tokens — held against a plain
  engine's streams, solo runs of each fork's seed and the eager step;
- `engine_tier` (f32): a pool too small for its traffic with the host
  KV tier behind it (fp, int8, and behind the in-device int8 tier), so
  preempted and recycled blocks demote and revive — held against a
  roomy engine's streams, with a spill / load_spill round trip;
- `split_path`: `CausalLM.prefill_chunk_paged` then
  `decode_step_paged` — the paged-decode kernel (the ragged kernels'
  split and combine kernels over one decode tile a sequence).
- `generate` (f32 and bf16): `CausalLM.generate` — `prefill` through
  the flash forward kernel, then `decode_step`s over a dense KV cache —
  held against the plain prefill, the dense forward, `prefill_paged`
  against solo prefills, and (f32) a `ServeEngine`'s greedy streams;
- `resume`: the train path saved by a `CheckpointManager` after 3 of 6
  steps and resumed by a Trainer made anew, bit for bit against the
  straight run; `optimizers`: the fourteen optimizers and
  `ModelAverage` on the card against the CPU.

Each kernel's launch count is set to 0 just before its path runs and
read just after; every path must launch its own kernels and no other. Each phase prints one JSON line; any failed check
raises and the script exits non-zero. The line before the last lists
the kernels; the last line is `{"ok": true, "device": {...}}`.

Without a CUDA card (and without --tiny) it exits non-zero and prints
no result. Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import logging
import shutil
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import optim
from paddle_tpu_torch.core import Trainer
from paddle_tpu_torch.engine import HostKVTier, ServeEngine
from paddle_tpu_torch.engine import engine as engine_mod
from paddle_tpu_torch.io import CheckpointManager, verify_checkpoint
from paddle_tpu_torch.kernels import attention, build, flash
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.ops import linear_cross_entropy
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.testing import (FLASH_ARGS, PAGED_ARGS, QUANT_ARGS,
                                      RAGGED_ARGS, STEP_ARGS, causal_lm_tree,
                                      decode_as_ragged, flash_case,
                                      int8_blocks, lm_stream,
                                      pack_prompts, packed_segment_ids,
                                      paged_case, ragged_case,
                                      write_serving_export)
from paddle_tpu_torch.utils.tree import flatten_with_keys

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

FLASH_SRC = "paddle_tpu_torch/kernels/csrc/flash_attention.cu"
# the bf16 forward, dq and dk/dv kernels (entry points in FLASH_SRC)
FLASH_TC_SRC = "paddle_tpu_torch/kernels/csrc/flash_tc.cuh"
# kernels 1, 2 and 3 (entry points in csrc/ragged_paged_attention.cu)
RAGGED_TC_SRC = "paddle_tpu_torch/kernels/csrc/ragged_tc.cuh"
SDPA_FWD = ("F.scaled_dot_product_attention(is_causal=True), forward, "
            "device time")
SDPA_BWD = ("F.scaled_dot_product_attention(is_causal=True), backward: "
            "dq, dk and dv in one call, device time, beside the sum of "
            "kernels 5 and 6")

KERNEL_ROWS = {
    # name: (source, the TPU kernel it replaces, library_ms note: why
    # it is null, or which PyTorch call it times)
    "ragged_paged_attention": (
        RAGGED_TC_SRC, "paddle_tpu/kernels/paged_attention.py:428",
        "no single PyTorch call computes a block-table-gathered ragged "
        "attention"),
    "ragged_paged_attention_mixed": (
        RAGGED_TC_SRC, "paddle_tpu/kernels/paged_attention.py:462",
        "no single PyTorch call reads int8 blocks through a bias-encoded "
        "table"),
    "paged_attention": (
        RAGGED_TC_SRC, "paddle_tpu/kernels/paged_attention.py:173",
        "no single PyTorch call gathers K/V through block tables; "
        "scaled_dot_product_attention needs the K/V gathered dense first"),
    "flash_fwd": (FLASH_TC_SRC, "paddle_tpu/kernels/flash.py:202",
                  SDPA_FWD),
    "flash_dq": (FLASH_TC_SRC, "paddle_tpu/kernels/flash.py:363",
                 SDPA_BWD),
    "flash_dkv": (FLASH_TC_SRC, "paddle_tpu/kernels/flash.py:419",
                  SDPA_BWD),
}
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


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


# flash kernel instantiations that must run on the tensor cores (bf16
# kernels 4, 5 and 6), by the name of their template in the source
TENSOR_CORE_KERNELS = {"flash_fwd": "fwd_tc_kernel",
                       "flash_dq": "dq_tc_kernel",
                       "flash_dkv": "dkv_tc_kernel"}
# the paged kernels' split template (kernels 1, 2 and 3,
# csrc/ragged_tc.cuh): its bf16 instantiations must hold HMMA (mma.sync),
# and none may spill
RAGGED_SPLIT_KERNEL = "split_kernel"
# what a GEMM kernel's name holds, in lower case (cuBLAS, cuBLASLt,
# CUTLASS), for the profiles' busy time by group
GEMM_NAME_KEYS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")


def ptxas_entries(report: str) -> Dict[str, dict]:
    """`nvcc -Xptxas -v` output -> per kernel entry (demangled where
    c++filt exists): registers and spill bytes."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
        elif name and "spill stores" in line:
            parts = line.split(",")
            out[name]["spill_store_bytes"] = int(parts[1].split()[0])
            out[name]["spill_load_bytes"] = int(parts[2].split()[0])
    return _demangle(out)


def _demangle(by_name: Dict[str, dict]) -> Dict[str, dict]:
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt is None or not by_name:
        return by_name
    names = list(by_name)
    res = subprocess.run([filt], input="\n".join(names), text=True,
                         capture_output=True, timeout=60)
    pretty = res.stdout.splitlines()
    if len(pretty) != len(names):
        return by_name
    return {_strip_params(p): by_name[n] for n, p in zip(names, pretty)}


def _strip_params(name: str) -> str:
    """A demangled function name without its parameter list (template
    arguments such as `(int)64` keep their parentheses)."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def sass_tensor_ops(library: Path) -> Optional[Dict[str, dict]]:
    """Per kernel of a built library, its count of HGMMA (wgmma) and
    HMMA (mma.sync) instructions in the SASS, from `cuobjdump -sass`;
    None when the toolkit has no cuobjdump."""
    exe = shutil.which("cuobjdump")
    if exe is None:
        cand = Path(build.nvcc_path()).parent / "cuobjdump"
        exe = str(cand) if cand.is_file() else None
    if exe is None:
        return None
    sass = subprocess.run([exe, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = {"HGMMA": 0, "HMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    out[name][op] += 1
    return _demangle(out)


def library_kernels(info) -> Tuple[Dict[str, dict], bool]:
    """Per kernel instantiation of a built library: ptxas's registers
    and spills, and (where cuobjdump exists) its HGMMA/HMMA count in the
    SASS; and whether the SASS was read."""
    sass = sass_tensor_ops(info.path)
    kernels = {}
    for name, r in ptxas_entries(info.ptxas).items():
        row = dict(r)
        if sass is not None:
            row.update(sass.get(name, {}))
        kernels[name] = row
    return kernels, sass is not None


def phase_build(cfg: dict, cuda: bool) -> Dict[str, bool]:
    """Build every kernel from this checkout's sources (one nvcc per
    source, in parallel); report ptxas's registers/spills, the dynamic
    shared memory a CTA takes at the paths' shapes, and for each paged
    and flash kernel instantiation its registers, spills and tensor-core
    instructions in the SASS. Fails if a bf16 split-kernel instantiation
    (kernels 1-3) has no HMMA or any of them spills, if a bf16 kernel 4, 5 or 6
    instantiation has no HGMMA, or if a SIMT flash kernel is built for
    bf16. Returns, per kernel, whether its bf16 path runs on the tensor
    cores."""
    if not cuda:
        emit({"phase": "build", "skipped": "no nvcc in a CPU rehearsal"})
        return {}
    t0 = time.perf_counter()
    infos = build.build_all()
    seconds = time.perf_counter() - t0
    d, bs, h = cfg["head_dim"], cfg["block_size"], cfg["num_heads"]
    emit({"phase": "build", "seconds": round(seconds, 3),
          "kernels": {n: {"library": str(i.path.name),
                          "nvcc_seconds": round(i.seconds, 3),
                          "ptxas": build.ptxas_report(n).splitlines()}
                      for n, i in infos.items()},
          "ragged_paged_attention_dynamic_smem_bytes": {
              str(dt).replace("torch.", ""): paged.shared_memory_bytes(
                  cfg["tile_q"], 1, d, bs, dtype=dt)
              for dt in (torch.float32, torch.bfloat16)},
          # the decode call: tile_q 1, G rows (MHA 1, GQA 8:2 4)
          "paged_attention_dynamic_smem_bytes": {
              str(dt).replace("torch.", ""): {
                  f"groups_{g}": paged.shared_memory_bytes(
                      1, g, d, bs, "paged_attention", dt)
                  for g in (1, h // cfg["gqa_kv_heads"])}
              for dt in (torch.float32, torch.bfloat16)},
          "flash_dynamic_smem_bytes": {
              str(dt).replace("torch.", ""): {
                  which: flash.shared_memory_bytes(which, d, dt)
                  for which in ("fwd", "dq", "dkv")}
              for dt in (torch.float32, torch.bfloat16)}})
    ragged, have_sass = library_kernels(infos["ragged_paged_attention"])
    split = {n: k for n, k in ragged.items() if RAGGED_SPLIT_KERNEL in n}
    check(bool(split), f"no {RAGGED_SPLIT_KERNEL} instantiation in the build")
    spills = {n: k for n, k in split.items()
              if k.get("spill_store_bytes", 0) or k.get("spill_load_bytes", 0)}
    check(not spills, f"ragged split kernels spill: {spills}")
    if have_sass:
        no_mma = [n for n, k in split.items()
                  if "bfloat16" in n and not k.get("HMMA", 0)]
        check(not no_mma, f"bf16 ragged kernels without HMMA: {no_mma}")
    emit({"phase": "build", "ragged_kernels": ragged,
          "cuobjdump": "found" if have_sass else
          "missing: no SASS instruction counts on this machine"})
    tensor_cores = dict.fromkeys(("ragged_paged_attention",
                                  "ragged_paged_attention_mixed",
                                  "paged_attention"), have_sass)
    kernels, have_sass = library_kernels(infos["flash_attention"])
    for kernel, template in TENSOR_CORE_KERNELS.items():
        inst = {n: k for n, k in kernels.items() if template in n}
        check(bool(inst), f"no {template} instantiation in the build")
        if have_sass:
            check(all(k.get("HGMMA", 0) > 0 for k in inst.values()),
                  f"{template}: an instantiation without HGMMA: {inst}")
        tensor_cores[kernel] = have_sass
    simt_bf16 = [n for n in kernels if "bfloat16" in n]
    check(not simt_bf16, f"SIMT flash kernels built for bf16: {simt_bf16}")
    emit({"phase": "build", "flash_kernels": kernels,
          "cuobjdump": "found" if have_sass else
          "missing: no SASS instruction counts on this machine"})
    return tensor_cores


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
    - paged decode: contexts from 1 to 1200, ends off the block grid;
      on the card its output must also equal, bit for bit, kernel 1's on
      the same rows packed as ragged decode rows (tile_q as the engine's).
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
            one = paged.ragged_paged_attention(
                *_to_device(decode_as_ragged(case, tq), dtype, device))[::tq]
            sync()
            equal = bool(torch.equal(got, one))
            emit({"phase": "kernel_vs_plain", "kernel": "paged_attention",
                  "against": "ragged_paged_attention on the same decode "
                             "rows", "tile_q": tq, **info,
                  "bit_equal": equal})
            check(equal or device.type != "cuda",
                  f"kernel 3 != kernel 1 on the same decode rows ({info})")
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
           card: dict, library_ms=None, iters=None, device_ms=None,
           **info) -> dict:
    """Time a kernel (and its plain version) at its path's shape with
    CUDA events around back-to-back launches; with `library_ms`, the
    time of the PyTorch call that computes the same function, measured
    by the caller. With `device_ms` (the caller's device-clock time),
    that is the kernel's `ms` and the events' figure `events_ms`: a
    kernel as short as one launch's host work makes the events time the
    host."""
    events_ms = time_ms(launch, iters or cfg["time_iters"], 10, cuda)
    ms = events_ms if device_ms is None else device_ms
    plain_ms = time_ms(plain, cfg["plain_iters"], 2, cuda)
    nbytes, flops = cost
    bytes_ms, ops_ms, bound_ms = bound(nbytes, flops, dtype)
    out = {"ms": ms, "device_ms": device_ms, "events_ms": events_ms,
           "plain_ms": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms,
           "library_ms": library_ms, "bytes": nbytes, "flops": flops}
    note = KERNEL_ROWS[name][2]
    emit({"phase": "kernel_time", "kernel": name,
          "dtype": str(dtype).replace("torch.", ""), **info,
          "device": card["kind"], "nvidia_smi": card["smi"], **out,
          "note": (f"library_ms null: {note}" if library_ms is None
                   else f"library_ms: {note}")})
    return out


def phase_kernel_time(cfg: dict, device: torch.device, card: dict) -> dict:
    """Each kernel, its plain version and its bound at its path's
    busiest shape, each kernel on the device's clock (`device_time`: the
    summed device time of a call's kernels — the ragged calls' split and
    combine kernels — over cfg["time_iters"] calls, with the host's
    enqueue time beside it) and under CUDA events around as many
    back-to-back calls. Launches cycle over one pool copy per model
    layer, as a step does, so the 50 MB L2 cache does not hold one
    launch's K/V blocks for the next.
    - ragged (fp, bf16 as the engine phase) and mixed (f32 as the
      engine_int8 phase serves, and bf16): the engine's busiest step,
      a 456-token chunk from 256 plus 7 decode rows; for the mixed
      kernel every other block before each row's query window is
      int8-resident (even table positions);
    - paged decode (f32 as the split_path phase, and bf16): 8 decode
      rows at contexts 300-1200 with tables of the LM's 128 blocks.
    Each line gives the split and combine kernels' device time apart.
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

    def timed(name, launch, plain, cost, dtype, **info):
        dev = device_time(launch, cfg["time_iters"], cuda)
        parts = {part: (sum(ms for n, ms in dev["kernel_ms"].items()
                            if key in n) if cuda else None)
                 for part, key in (("split_ms", "split_kernel"),
                                   ("combine_ms", "combine_kernel"))}
        return _timed(name, launch, plain, cost, dtype, cfg, cuda, card,
                      device_ms=dev["device_ms"], clock=dev["clock"],
                      host_enqueue_ms=dev["host_enqueue_ms"],
                      device_kernel_ms=dev["kernel_ms"], **parts, **info)

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
            out["ragged_paged_attention"] = timed(
                "ragged_paged_attention",
                lambda: paged.ragged_paged_attention(q, *next(pools), *meta),
                lambda: paged.ragged_paged_attention_reference(
                    q, *next(pools), *meta),
                step_cost(args, q.element_size()), dtype, **info)
        margs, quant, _, n8 = mixed_args(*geom, half_prefix)
        mmeta = margs[3:]
        mpools = cycle((margs[1], margs[2], quant["kq_pool"],
                        quant["vq_pool"]))

        def mixed(fn):
            k, v, kq, vq = next(mpools)
            return fn(q, k, v, *mmeta, kq_pool=kq, vq_pool=vq,
                      k_scales=quant["k_scales"],
                      v_scales=quant["v_scales"])
        timing = timed(
            "ragged_paged_attention_mixed",
            lambda: mixed(paged.ragged_paged_attention),
            lambda: mixed(paged.ragged_paged_attention_reference),
            step_cost(margs, q.element_size()), dtype, int8_blocks=n8,
            **info)
        if dtype == torch.float32:
            out["ragged_paged_attention_mixed"] = timing
        case = paged_case(cfg["paged_time_lens"], h, h, d, bs,
                          cfg["num_blocks"], cfg["max_blocks"], SEED + 6)
        pargs = _to_device(case, dtype, device, PAGED_ARGS)
        ppools = cycle((pargs[1], pargs[2]))
        timing = timed(
            "paged_attention",
            lambda: paged.paged_attention(pargs[0], *next(ppools),
                                          *pargs[3:]),
            lambda: paged.paged_attention_reference(pargs[0], *next(ppools),
                                                    *pargs[3:]),
            decode_cost(pargs, pargs[0].element_size()), dtype,
            rows=len(cfg["paged_time_lens"]),
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
    for fn in (flash.flash_fwd, flash.flash_dq, flash.flash_dkv):
        fn.launches = 0


def _launches() -> Dict[str, int]:
    return {"ragged_paged_attention": paged.ragged_paged_attention.launches,
            "ragged_paged_attention_mixed":
                paged.ragged_paged_attention.mixed_launches,
            "paged_attention": paged.paged_attention.launches,
            "flash_fwd": flash.flash_fwd.launches,
            "flash_dq": flash.flash_dq.launches,
            "flash_dkv": flash.flash_dkv.launches}


def _expect_launches(kernels, steps: int, layers: int,
                     cuda: bool) -> Dict[str, int]:
    """After a path's run: each of `kernels` (a name or a tuple of
    names) launched once per layer per step and no other kernel
    launched (on the CPU nothing launches)."""
    kernels = (kernels,) if isinstance(kernels, str) else kernels
    got = _launches()
    want = dict.fromkeys(got, 0)
    if cuda:
        want.update(dict.fromkeys(kernels, steps * layers))
    check(got == want, f"kernel launches {got} != {want} ({steps} steps "
                       f"x {layers} layers through {kernels})")
    return got


def check_one_program(engine, cuda: bool) -> dict:
    """After a path's run: the engine holds one step program, on the
    card one captured CUDA graph, and its compile gauge reads 1; one
    step shape. Returns the program's numbers for the phase's line."""
    g = engine.step_graph
    compiles = engine.obs.get("ptpu_engine_compiles").value
    check(len(g.graphs) == (1 if cuda else 0) and g.compiles == 1
          and compiles == 1,
          f"{len(g.graphs)} graphs, {g.compiles} programs, gauge "
          f"{compiles} (want {int(cuda)}, 1, 1)")
    check(len(engine.step_shapes) == 1,
          f"{len(engine.step_shapes)} step shapes (want 1)")
    return {"graphs": len(g.graphs), "compiles": compiles,
            "capture_ms": g.capture_ms, "warmup_ms": g.warmup_ms}


def serve_profile(engine, prefix: List[int], cfg: dict, seed: int,
                  cuda: bool) -> dict:
    """After the counted `engine` run (its launches are not counted):
    two fresh waves of one shape on the same engine, prefix hits of
    equal lengths, the first unprofiled with every step on the host
    clock, the second traced under `torch.profiler`. The card's busy ms
    a step (device activities of the trace, by group: the ragged split
    and combine kernels, GEMMs, copies, other) against the unprofiled
    wave's mean step gives the idle share while serving. Then the host's
    time to enqueue one replay of the graph, and one whole pad-only
    program step (operand copy, replay, logits copy, synchronisation).
    On the CPU (--tiny) the waves run and nothing on a device is
    measured."""
    rng = np.random.default_rng(seed)
    vocab, n_new = cfg["vocab"], cfg["max_new"]
    waves = [[prefix + rng.integers(0, vocab, 5 + 7 * i).tolist()
              for i in range(cfg["max_batch"])] for _ in range(2)]

    def drain(wave) -> List[float]:
        for p in wave:
            engine.add_request(p, max_new_tokens=n_new)
        walls = []
        while True:
            t0 = time.perf_counter()
            if not engine.step():
                return walls
            walls.append((time.perf_counter() - t0) * 1e3)

    plain = drain(waves[0])
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        traced = drain(waves[1])
    walls = {"steps": len(plain), "traced_steps": len(traced),
             "step_ms_median": float(np.median(plain)),
             "step_ms_mean": float(np.mean(plain)),
             "traced_step_ms_median": float(np.median(traced))}
    if not cuda:
        return {**walls, "device_busy_ms_per_step": None,
                "idle_share": None, "clock": "not measured (no card)"}
    groups = {"ragged_split": RAGGED_SPLIT_KERNEL,
              "ragged_combine": "combine_kernel"}
    by_group = dict.fromkeys(list(groups) + ["gemm", "memcpy", "other"],
                             0.0)
    events = device_events(prof)
    for name, us in events.items():
        low = name.lower()
        group = next((g for g, key in groups.items() if key in name), None)
        if group is None:
            group = ("gemm" if any(k in low for k in GEMM_NAME_KEYS)
                     else "memcpy" if low.startswith("memcpy") else "other")
        by_group[group] += us / 1e3 / len(traced)
    busy = sum(by_group.values())
    check(by_group["ragged_split"] > 0,
          f"no ragged split kernel in the serve trace: {sorted(events)}")
    g = engine.step_graph
    graph = g.graphs[0]
    iters = 50
    g.clear()
    t0 = time.perf_counter()
    for _ in range(iters):
        g.run()
    pad_step = (time.perf_counter() - t0) * 1e3 / iters
    enqueue = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        graph.replay()
        enqueue += time.perf_counter() - t0
        torch.cuda.synchronize()
    top = sorted(events.items(), key=lambda kv: -kv[1])[:8]
    return {**walls, "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / walls["step_ms_mean"],
            "idle_share_traced": 1.0 - busy * len(traced) / sum(traced),
            "busy_ms_per_step_by_group": by_group,
            "host_ms_per_replay": enqueue * 1e3 / iters,
            "pad_step_ms": pad_step,
            "top_kernels_ms_per_step": {
                n[:120]: us / 1e3 / len(traced) for n, us in top},
            "clock": "torch.profiler device time; host perf_counter"}


def phase_graph_vs_eager(cfg: dict, tree: dict, device: torch.device,
                         card: dict) -> None:
    """The step program against the eager step it replaces: after every
    step of a wave at full width (8 prompts on a shared prefix, chunked
    prefill with decode rows riding), `StepGraph.eager()` runs the
    model's `ragged_step_paged` on the same staged operands and pools,
    and its logits must equal the graph's bit for bit; the largest gap
    is printed either way. The fp engine (kernel 1) and the int8-tier
    engine (kernel 2), each in f32 and bf16. Outside any counted window:
    the eager steps launch kernels."""
    rng = np.random.default_rng(SEED + 11)
    vocab = cfg["vocab"]
    prefix = rng.integers(0, vocab, cfg["prefix"]).tolist()
    prompts = [prefix + rng.integers(0, vocab, 16 + 9 * i).tolist()
               for i in range(cfg["max_batch"])]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        model = _lm(cfg, tree, dtype, device)
        for compress in (0, cfg["int8"]["compress_blocks"]):
            eng = ServeEngine(
                model, block_size=cfg["block_size"],
                num_blocks=cfg["num_blocks"],
                max_batch_size=cfg["max_batch"],
                max_prefill_tokens=cfg["max_prefill"], tile_q=cfg["tile_q"],
                kv_compress_blocks=compress, device=device)
            for p in prompts:
                eng.add_request(p, max_new_tokens=4)
            worst, unequal = 0.0, 0
            while eng.step():
                got = eng.step_graph.logits.clone()
                want = eng.step_graph.eager()
                check(bool(torch.isfinite(got).all()),
                      "non-finite step logits")
                worst = max(worst, float((got - want).abs().max()))
                unequal += not torch.equal(got, want)
            cases.append({"dtype": str(dtype).replace("torch.", ""),
                          "int8_tier": bool(compress),
                          "graphs": len(eng.step_graph.graphs),
                          "steps": eng.steps, "unequal_steps": unequal,
                          "max_abs_gap": worst})
    # the engines hold each other in reference cycles (scheduler hooks):
    # free them, their pools and their graphs' pools before the measured
    # phases, so that `engine`'s peak memory is its own
    del eng, model
    gc.collect()
    emit({"phase": "graph_vs_eager", "cases": cases,
          "device": card["kind"]})
    check(all(c["unequal_steps"] == 0 for c in cases),
          f"graph logits != eager logits: {cases}")


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

    before = torch.cuda.memory_allocated() if cuda else None
    engine = ServeEngine(model, **engine_kw)
    # what the step program holds beyond the KV pools: the staging
    # buffers, the static logits and the graph's pool
    program_bytes = None
    if cuda:
        program_bytes = torch.cuda.memory_allocated() - before - sum(
            t.nbytes for pair in engine.cache.pools for t in pair)
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
    reserved = torch.cuda.max_memory_reserved() if cuda else None

    reqs = reqs1 + reqs2
    for r in reqs:
        check(r.finish_reason == "length" and len(r.generated) == n_new,
              f"request {r.req_id} ended {r.finish_reason!r} after "
              f"{len(r.generated)} tokens")
    stats = engine.stats()
    check(stats["hit_tokens"] > 0, "second wave missed the prefix cache")
    graph = check_one_program(engine, cuda)
    engine.cache.assert_quiesced()

    # batched == solo: the long wave-1 request and a wave-2 prefix hit
    # run alone on fresh engines (each replaying its own graph) must
    # give the same streams
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
           "peak_bytes": peak, "peak_reserved_bytes": reserved,
           "program_bytes": program_bytes,
           "kernel_launches": launches,
           **graph, "layers": layers, "hit_tokens": stats["hit_tokens"],
           "prompt_tokens": stats["prompt_tokens"],
           "batched_equals_solo": True, "device": card["kind"],
           "nvidia_smi": card["smi"]}
    emit({"phase": "engine", **out})
    emit({"phase": "serve_profile",
          **serve_profile(engine, prefix, cfg, SEED + 12, cuda),
          "device": card["kind"], "nvidia_smi": card["smi"]})
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
    graph = check_one_program(engine, cuda)
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
    out = {"steps": engine.steps, "kernel_launches": launches, **graph,
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
    steps_out = []                      # (sequences so far, step logits)
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
            steps_out.append(([list(x) for x in seqs], logits))
    if cuda:
        torch.cuda.synchronize()
    launches = _expect_launches("paged_attention", steps,
                                len(model.blocks), cuda)
    # the dense oracle runs after the count: on the card its attention
    # is the flash forward kernel
    worst = 0.0
    with torch.inference_mode():
        for seqs_i, logits in steps_out:
            dense = torch.stack([model(torch.tensor([s], device=device))
                                 [0, -1] for s in seqs_i])
            worst = max(worst, float((logits - dense).abs().max()))
            check(bool(torch.isfinite(logits).all()),
                  "non-finite decode logits")
    out = {"decode_steps": steps, "rows": b, "kernel_launches": launches,
           "layers": len(model.blocks), "dtype": "float32",
           "max_abs_err_vs_dense": worst, "atol": 1e-3,
           "device": card["kind"]}
    emit({"phase": "split_path", **out})
    check(worst <= 1e-3, f"split path vs dense forward: {worst} > 1e-3")
    return out


# -- speculative decoding, n-best forks and the host KV tier --------------

def _engine_kw(cfg: dict, device: torch.device, **kw) -> dict:
    """An engine's options at the config's width, with a registry of its
    own, so that its counters count its traffic alone."""
    return dict(dict(block_size=cfg["block_size"],
                     num_blocks=cfg["num_blocks"],
                     max_batch_size=cfg["max_batch"],
                     max_prefill_tokens=cfg["max_prefill"],
                     tile_q=cfg["tile_q"], device=device,
                     registry=MetricsRegistry()), **kw)


@contextlib.contextmanager
def host_ms(acc: Dict[str, float], **targets):
    """While open, every call of each target (name=(object, attribute))
    adds its host ms to acc[name]; the attributes are put back after."""
    saved = {name: getattr(obj, attr) for name, (obj, attr)
             in targets.items()}

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                acc[name] = (acc.get(name, 0.0)
                             + (time.perf_counter() - t0) * 1e3)
        return call

    for name, (obj, attr) in targets.items():
        setattr(obj, attr, timed(name, saved[name]))
    try:
        yield acc
    finally:
        for name, (obj, attr) in targets.items():
            setattr(obj, attr, saved[name])


def _drain(engine, greedy: List[List[int]], groups, new: int,
           gaps: Optional[dict] = None) -> Tuple[list, list, float, dict]:
    """Serve the greedy prompts and the n-best groups (prompt, seed) on
    `engine`; returns (greedy requests, group candidate lists, wall s,
    host ms by part: the step program's runs (operand copy, replay,
    logits copy, synchronisation), host sampling, drafting). With
    `gaps`, every sampled token records its logits' top-2 gap."""
    sc_n = groups[0][2] if groups else 1
    targets = {"program_run": (engine.step_graph, "run"),
               "sample": (engine_mod, "_sample")}
    if engine.drafter is not None:
        targets["draft"] = (engine.drafter, "propose")
    ctx = recorded_engine_gaps(gaps) if gaps is not None \
        else host_ms({}, **targets)
    cuda = engine.device.type == "cuda"
    with ctx as parts:
        t0 = time.perf_counter()
        reqs = [engine.add_request(p, max_new_tokens=new) for p in greedy]
        heads = [engine.add_request(p, max_new_tokens=new, temperature=0.8,
                                    seed=seed, n=sc_n)
                 for p, seed, _ in groups]
        engine.run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cands = [[h] + sorted(h.forks, key=lambda f: f.cand_index)
             for h in heads]
    return reqs, cands, wall, (parts if gaps is None else {})


def _pad_step_ms(engine, iters: int) -> float:
    """Host ms of one pad-only program step: the operand copy, the
    replay, the logits' copy to the host and the synchronisation."""
    g = engine.step_graph
    g.clear()
    g.run()
    t0 = time.perf_counter()
    for _ in range(iters):
        g.run()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_engine_spec(cfg: dict, tree: dict, device: torch.device,
                      card: dict) -> dict:
    """Speculative decoding and n-best forks at full width, f32 then
    bf16: `max_batch` greedy requests whose prompts repeat a seeded span
    (the prompt-lookup drafter's case) and two n-best groups at
    temperature 0.8, through a `spec_k` engine and a plain one of the
    same options. Checks (f32): the greedy streams equal the plain
    engine's up to the first position where either engine's top-2
    logits lie within 1e-4 (the head GEMM runs on B x spec_len rows, not
    B, so an ulp may move), and such splits are counted; each fork's
    stream equals a solo run of its seed on a speculating engine (same
    shapes, so bit for bit; both dtypes); drafts were made; one graph
    per engine; and on another speculating engine, the graph's logits
    equal the eager step's after every step with drafts in the batch.
    Kernel 1 launches once per layer per step of the counted spec run."""
    cuda = device.type == "cuda"
    sc = cfg["spec"]
    rng = np.random.default_rng(SEED + 30)
    vocab, new, k = cfg["vocab"], sc["new"], sc["k"]
    spans = [rng.integers(0, vocab, sc["span"]).tolist()
             for _ in range(cfg["max_batch"] + sc["groups"])]
    prompts = [(s * (-(-sc["prompt"] // len(s))))[:sc["prompt"]]
               for s in spans]
    greedy = prompts[:cfg["max_batch"]]
    groups = [(p, SEED + 100 * i, sc["n"])
              for i, p in enumerate(prompts[cfg["max_batch"]:])]
    layers = cfg["lm"]["num_layers"]
    out, launches = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        model = _lm(cfg, tree, dtype, device)
        runs = {}
        for spec_k in (0, k):
            kw = _engine_kw(cfg, device, spec_k=spec_k)
            ServeEngine(model, **kw).generate([greedy[0]], max_new_tokens=4)
            engine = ServeEngine(model, **kw)
            if spec_k and dtype == torch.float32:
                _reset_launches()                   # the path's counts
            reqs, cands, wall, parts = _drain(engine, greedy, groups, new)
            if spec_k and dtype == torch.float32:
                launches = _expect_launches("ragged_paged_attention",
                                            engine.steps, layers, cuda)
            graph = check_one_program(engine, cuda)
            engine.cache.assert_quiesced()
            gaps: Dict[Tuple[int, int], float] = {}
            again = ServeEngine(model, **kw)
            rreqs, rcands, _, _ = _drain(again, greedy, groups, new, gaps)
            check([r.generated for r in rreqs] == [r.generated for r in reqs]
                  and [[c.generated for c in g] for g in rcands]
                  == [[c.generated for c in g] for g in cands],
                  f"{name} spec_k {spec_k}: two runs differ")
            tokens = new * (len(greedy) + sum(len(g) for g in cands))
            runs[spec_k] = dict(
                reqs=rreqs, cands=cands, gaps=gaps, engine=engine,
                steps=engine.steps, wall_s=wall, tokens_per_s=tokens / wall,
                host_ms=parts,
                pad_step_ms=_pad_step_ms(engine, 20) if cuda else None,
                graph=graph,
                drafted=engine.obs.get(
                    "ptpu_spec_drafted_tokens_total").value,
                accepted=engine.obs.get(
                    "ptpu_spec_accepted_tokens_total").value)
        plain, spec = runs[0], runs[k]
        rows = []
        for rp, rs in zip(plain["reqs"], spec["reqs"]):
            plen = len(rp.prompt)
            rows.append(_stream_split(
                rp.generated, rs.generated,
                [plain["gaps"][(rp.req_id, plen + i)] for i in range(new)],
                [spec["gaps"][(rs.req_id, plen + i)] for i in range(new)],
                1e-4))
        fork_ok = []
        for (prompt, seed, _), cands in zip(groups, spec["cands"]):
            for c in cands:
                alone = ServeEngine(model, **_engine_kw(
                    cfg, device, spec_k=k)).generate(
                        [prompt], max_new_tokens=new, temperature=0.8,
                        seed=seed + c.cand_index)[0]
                fork_ok.append(alone == c.generated)
        check(all(fork_ok), f"{name}: fork streams != solo runs {fork_ok}")
        check(spec["drafted"] > 0, f"{name}: no draft was made")
        splits = [r for r in rows if r["agreed"] < new]
        if dtype == torch.float32:
            check(all(r["ok"] for r in rows),
                  f"spec vs plain greedy streams split before a near tie: "
                  f"{splits}")
        # the graph against the eager step, drafts in the batch
        eng = ServeEngine(model, **_engine_kw(cfg, device, spec_k=k))
        for p in greedy:
            eng.add_request(p, max_new_tokens=sc["eager_new"])
        unequal = draft_steps = 0
        while eng.step():
            got = eng.step_graph.logits.clone()
            check(bool(torch.isfinite(got).all()), "non-finite logits")
            unequal += not torch.equal(got, eng.step_graph.eager())
            idx = eng.step_graph.operands["last_idx"]
            draft_steps += bool((idx[:, 1:] != idx[:, :1]).any())
        check(unequal == 0 and draft_steps > 0,
              f"{name}: {unequal} graph steps != eager ({draft_steps} with "
              "drafts)")
        res = {"spec_k": k, "requests": len(greedy),
               "groups": [len(g) for g in spec["cands"]],
               "new_tokens": new, "drafted": spec["drafted"],
               "accepted": spec["accepted"],
               "accept_ratio": spec["accepted"] / max(spec["drafted"], 1),
               "steps": spec["steps"], "plain_steps": plain["steps"],
               "tokens_per_s": spec["tokens_per_s"],
               "plain_tokens_per_s": plain["tokens_per_s"],
               "wall_s": spec["wall_s"], "plain_wall_s": plain["wall_s"],
               "host_ms": spec["host_ms"],
               "plain_host_ms": plain["host_ms"],
               "pad_step_ms": spec["pad_step_ms"],
               "plain_pad_step_ms": plain["pad_step_ms"],
               "logits_bytes_per_step": 4 * cfg["max_batch"] * (k + 1)
               * vocab,
               "plain_logits_bytes_per_step": 4 * cfg["max_batch"] * vocab,
               "greedy_tokens_agreed": sum(r["agreed"] for r in rows),
               "greedy_tokens": new * len(rows), "splits": splits,
               "forks_equal_solo": len(fork_ok),
               "graph_vs_eager_steps": eng.steps,
               "graph_vs_eager_draft_steps": draft_steps,
               **spec["graph"], "device": card["kind"],
               "nvidia_smi": card["smi"]}
        if dtype == torch.float32:
            res["kernel_launches"] = launches
        emit({"phase": "engine_spec", "dtype": name, **res})
        out[name] = res
        del model, runs, eng
        gc.collect()
    return out


def _tier_entries(tier) -> list:
    """A tier's entries in LRU order, every payload as raw bytes."""
    return [(key, ent.nbytes, [tuple(p.tobytes() if isinstance(p, np.ndarray)
                                     else p for p in blob)
                               for blob in ent.blobs])
            for key, ent in tier._entries.items()]


def phase_engine_tier(cfg: dict, tree: dict, device: torch.device,
                      card: dict) -> dict:
    """The host KV tier at full width, f32: `max_batch` prompts on a pool
    too small for them (decode growth preempts, and the victims' blocks
    demote to the tier), filler waves that recycle the cached-free
    blocks (evictions demote), and the first wave's prompts again, which
    revive from the tier. Runs: an fp tier, whose streams must equal a
    roomy engine's exactly; an int8 tier, which must revive and
    complete; and an fp tier behind the in-device int8 tier
    (kv_compress_blocks), whose compressed entries spill to the host.
    Each run keeps one graph; a spill / load_spill round trip in a
    temporary directory gives the same entries. The revival writes are
    timed on the host clock (synchronised), lane batch by lane batch."""
    cuda = device.type == "cuda"
    tc = cfg["tier"]
    rng = np.random.default_rng(SEED + 40)
    vocab, new = cfg["vocab"], tc["new"]
    wave = [rng.integers(0, vocab, tc["prompt"]).tolist()
            for _ in range(cfg["max_batch"])]
    fillers = [[rng.integers(0, vocab, tc["prompt"]).tolist()
                for _ in range(cfg["max_batch"])]
               for _ in range(tc["filler_waves"])]
    layers = cfg["lm"]["num_layers"]
    model = _lm(cfg, tree, torch.float32, device)

    def serve(**kw):
        eng = ServeEngine(model, **_engine_kw(cfg, device, **kw))
        lanes: List[float] = []
        if eng.host_tier is not None:
            write = eng._write_revivals

            def timed(batch):
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                write(batch)
                if cuda:
                    torch.cuda.synchronize()
                lanes.append((time.perf_counter() - t0) * 1e3)
            eng._write_revivals = timed
        t0 = time.perf_counter()
        streams = eng.generate(wave, max_new_tokens=new)
        for f in fillers:
            eng.generate(f, max_new_tokens=4)
        streams += eng.generate(wave, max_new_tokens=new)
        if cuda:
            torch.cuda.synchronize()
        return eng, streams, lanes, time.perf_counter() - t0

    roomy, want, _, roomy_s = serve(num_blocks=tc["roomy_blocks"])
    runs = {}
    for name, kw, kernel in (
            ("fp", dict(), "ragged_paged_attention"),
            ("int8", dict(kv_tier_int8=True), "ragged_paged_attention"),
            ("fp_behind_int8", dict(kv_compress_blocks=tc["compress_blocks"]),
             "ragged_paged_attention_mixed")):
        _reset_launches()                           # the path's counts
        eng, got, lanes, wall = serve(num_blocks=tc["num_blocks"],
                                      host_tier_bytes=tc["bytes"], **kw)
        launches = _expect_launches(kernel, eng.steps, layers, cuda)
        st = eng.stats()
        preempted = int(eng.obs.get("ptpu_sched_preemptions_total").value)
        demoted = eng.obs.get("ptpu_kv_tier_demoted_blocks_total")
        check(all(len(s) == new for s in got), f"{name}: a request did not "
                                               "complete")
        check(st["tier_revivals"] > 0, f"{name}: nothing revived: {st}")
        graph = check_one_program(eng, cuda)
        eng.cache.assert_quiesced()
        with tempfile.TemporaryDirectory() as d:
            n = eng.host_tier.spill(d)
            back = HostKVTier(tc["bytes"], int8=eng.host_tier.int8,
                              registry=MetricsRegistry())
            check(back.load_spill(d) == n > 0
                  and _tier_entries(back) == _tier_entries(eng.host_tier),
                  f"{name}: spill / load_spill changed the entries")
        res = {"steps": eng.steps, "wall_s": wall,
               "preemptions": preempted,
               "demoted": {r: demoted.labels(reason=r).value
                           for r in ("evict", "preempt")},
               "tier_revivals": st["tier_revivals"],
               "tier_hit_tokens": st["tier_hit_tokens"],
               "tier_entries": st["tier_entries"],
               "tier_bytes": st["tier_bytes"],
               "revival_lane_batches": len(lanes),
               "revival_ms": lanes, "revival_ms_total": sum(lanes),
               "spill_entries": n, "kernel_launches": launches, **graph}
        if name == "fp":
            same = got == want
            res["streams_equal_roomy"] = same
            check(same, "fp tier streams != the roomy engine's")
            check(preempted > 0 and res["demoted"]["preempt"] > 0,
                  f"no preempted sequence demoted: {res}")
        if name == "fp_behind_int8":
            res["compress_spills"] = st["compress_spills"]
            check(st["compress_spills"] > 0, "no compressed entry spilled")
        runs[name] = res
        del eng
        gc.collect()
    out = {"requests": 2 * len(wave), "prompt": tc["prompt"],
           "new_tokens": new, "num_blocks": tc["num_blocks"],
           "roomy_blocks": tc["roomy_blocks"], "roomy_steps": roomy.steps,
           "roomy_wall_s": roomy_s, "runs": runs, "dtype": "float32",
           "device": card["kind"], "nvidia_smi": card["smi"]}
    emit({"phase": "engine_tier", **out})
    del model, roomy
    gc.collect()
    return out


# -- training: the flash kernels ------------------------------------------

def _flash_inputs(b: int, t: int, h: int, hkv: int, d: int,
                  dtype: torch.dtype, device: torch.device, seed: int):
    """(q, k, v, do) on `device` in `dtype`: k/v made with hkv heads and
    repeated to h as `attention.mha` does before its flash call."""
    case = flash_case(b, t, t, h, d, seed)
    q, k, v, do = (torch.from_numpy(case[x]).to(device) for x in FLASH_ARGS)
    k, v = k[:, :, :hkv], v[:, :, :hkv]
    k = k.repeat_interleave(h // hkv, dim=2)
    v = v.repeat_interleave(h // hkv, dim=2)
    return [x.to(dtype).contiguous() for x in (q, k, v, do)]


def _flash_mode(mode: str, b: int, t: int, device: torch.device):
    """(kwargs, q_seg, kv_seg, seed) of a causal check: plain causal,
    causal over packed documents, or causal with dropout 0.1."""
    kw = dict(causal=True)
    segs = seed = None
    if mode == "segments":
        docs = [(t // 3, t // 4, t // 5), (t // 2,), (t // 7, t // 2),
                (t // 5,) * 4]
        segs = torch.from_numpy(np.stack(
            [packed_segment_ids(docs[i % len(docs)], t)
             for i in range(b)])).to(device)
    if mode == "dropout":
        kw["dropout_rate"] = 0.1
        seed = torch.tensor([SEED], dtype=torch.int32, device=device)
    return kw, segs, segs, seed


def _flash_close(kernel: str, got, plain, atol: float, rtol: float,
                 **info) -> float:
    err = float((got.float() - plain).abs().max())
    ratio = float(((got.float() - plain).abs()
                   / (atol + rtol * plain.abs())).max())
    emit({"phase": "flash_vs_plain", "kernel": kernel, **info,
          "max_abs_err": err, "atol": atol, "rtol": rtol,
          "worst_err_over_tol": ratio, "ok": ratio <= 1.0})
    check(bool(torch.isfinite(got).all()), f"{kernel}: non-finite output")
    check(ratio <= 1.0, f"{kernel} vs plain: {err} over atol {atol} + "
                        f"rtol {rtol} ({info})")
    return err


def phase_flash_vs_plain(cfg: dict, device: torch.device) -> dict:
    """Kernels 4, 5 and 6 each against its plain version on the same
    inputs at the train phase's attention shape (cfg["flash_check"]: B 4,
    T 2048, H 8, D 64 on the card), MHA and GQA 8:2 (k/v repeated as `mha` repeats them), causal,
    causal over packed documents, and causal with dropout 0.1; f32 at
    1e-5 (o, lse) and 1e-4 (dq, dk, dv), bf16 against the plain version
    run in f32 on the same bf16 values at 2e-2 (absolute and relative:
    the kernel rounds p, ds and g to bf16). The backward kernels take
    the plain forward's o and lse, so each kernel is held alone. Then
    GQA end to end: `mha` with 2 kv heads on the card against autograd
    through the plain forward over the repeated heads. Returns the worst
    error per kernel."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    b, t, h, d = cfg["flash_check"]
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    for hkv in (h, cfg["gqa_kv_heads"]):
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            otol = (1e-5, 1e-5) if f32 else (2e-2, 2e-2)
            gtol = (1e-4, 1e-4) if f32 else (2e-2, 2e-2)
            for mode in ("causal", "segments", "dropout"):
                info = dict(heads=h, kv_heads=hkv, mode=mode, t=t, d=d,
                            dtype=str(dtype).replace("torch.", ""))
                q, k, v, do = _flash_inputs(b, t, h, hkv, d, dtype, device,
                                            SEED + hkv)
                kw, q_seg, kv_seg, seed = _flash_mode(mode, b, t, device)
                kw["scale"] = d ** -0.5
                plain = [x.float() for x in (q, k, v, do)]
                o, lse = flash.flash_fwd(q, k, v, q_seg, kv_seg, seed, **kw)
                o_ref, lse_ref = flash.flash_fwd_reference(
                    *plain[:3], q_seg, kv_seg, seed, **kw)
                sync()
                worst["flash_fwd"] = max(
                    worst["flash_fwd"],
                    _flash_close("flash_fwd", o, o_ref, *otol, **info),
                    _flash_close("flash_fwd", lse, lse_ref, *otol,
                                 output="lse", **info))
                o_in = o_ref.to(dtype)
                args = (q, k, v, o_in, lse_ref, do, q_seg, kv_seg, seed)
                ref = (*plain[:3], o_in.float(), lse_ref, plain[3], q_seg,
                       kv_seg, seed)
                dq = flash.flash_dq(*args, **kw)
                dk, dv = flash.flash_dkv(*args, **kw)
                sync()
                worst["flash_dq"] = max(worst["flash_dq"], _flash_close(
                    "flash_dq", dq, flash.flash_dq_reference(*ref, **kw),
                    *gtol, **info))
                dk_ref, dv_ref = flash.flash_dkv_reference(*ref, **kw)
                worst["flash_dkv"] = max(
                    worst["flash_dkv"],
                    _flash_close("flash_dkv", dk, dk_ref, *gtol,
                                 output="dk", **info),
                    _flash_close("flash_dkv", dv, dv_ref, *gtol,
                                 output="dv", **info))
    # GQA end to end through mha (kernels on the card), f32
    hkv = cfg["gqa_kv_heads"]
    case = flash_case(b, t, t, h, d, SEED + 3)
    leaves = [torch.from_numpy(case["q"]).to(device)] + [
        torch.from_numpy(case[x][:, :, :hkv]).to(device).contiguous()
        for x in "kv"]
    do = torch.from_numpy(case["do"]).to(device)
    outs = []
    for through_mha in (True, False):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        if through_mha:
            o = attention.mha(*xs, causal=True)
        else:
            rep = [xs[0]] + [x.repeat_interleave(h // hkv, dim=2)
                             for x in xs[1:]]
            o, _ = flash.flash_fwd_reference(*rep, scale=d ** -0.5,
                                             causal=True)
        o.backward(do)
        outs.append([o.detach()] + [x.grad for x in xs])
    sync()
    for name, got, want in zip(("o", "dq", "dk", "dv"), *outs):
        _flash_close("mha_gqa", got, want, *((1e-5, 1e-5) if name == "o"
                                              else (1e-4, 1e-4)),
                     output=name, heads=h, kv_heads=hkv, t=t, d=d,
                     dtype="float32")
    return worst


def flash_cost(q, k, vis_pairs: int, which: str) -> Tuple[float, float]:
    """(bytes, FLOPs) kernel `which` must at least move and do: each
    operand read once and each output written once (lse [B, H, Tq] f32),
    and per visible (q, k) pair and head 4*D FLOPs forward (q.k, p.v),
    6*D for dq (s, dp, dq), 8*D for dk/dv (s, dv, dp, dk)."""
    b, t_q, h, d = q.shape
    e = q.element_size()
    nq, nk = q.numel(), k.numel()
    lse = 4 * b * h * t_q
    if which == "fwd":
        nbytes, per = e * (2 * nq + 2 * nk) + lse, 4
    elif which == "dq":
        nbytes, per = e * (4 * nq + 2 * nk) + lse, 6
    else:
        nbytes, per = e * (3 * nq + 4 * nk) + lse, 8
    return float(nbytes), float(per * d * vis_pairs)


def sdpa_backend(names: Sequence[str]) -> str:
    """Which backend of scaled_dot_product_attention ran, from the names
    of the kernels in its trace."""
    low = " ".join(names).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if key in low:
            return backend
    return "unknown"


def device_events(prof) -> Dict[str, float]:
    """Device time, us, by name of what ran on the card (kernels,
    memsets, copies) in a `torch.profiler` trace. Only the device's own
    activities count: a CPU op's device time, or a user annotation's
    device span (`Optimizer.step#Adam.step`), is its kernels' again."""
    events = prof.events()
    cpu_names = {e.name for e in events
                 if e.device_type != torch.autograd.DeviceType.CUDA}
    out = {}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name in cpu_names
                or e.name.startswith("Activity Buffer")):
            continue
        out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return out


def device_time(fn, iters: int, cuda: bool) -> dict:
    """Device time of one call of `fn`, ms: the summed device time of the
    kernels in a `torch.profiler` trace of `iters` calls (or, if the
    trace holds no device time, CUDA-graph replays under CUDA events),
    with the host's enqueue time per call beside it and each kernel's
    device time (`kernel_ms`, by name; the ragged calls' split and
    combine kernels apart)."""
    if not cuda:
        return {"device_ms": None, "host_enqueue_ms": None,
                "clock": "not measured (no card)", "kernels": [],
                "kernel_ms": {}}
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
    per_kernel = device_events(prof)
    total_us = sum(per_kernel.values())
    out = {"host_enqueue_ms": host * 1e3 / iters,
           "kernels": sorted(per_kernel),
           "kernel_ms": {n: us / 1e3 / iters
                         for n, us in sorted(per_kernel.items())}}
    if total_us > 0:
        return {"device_ms": total_us / 1e3 / iters,
                "clock": "torch.profiler device time", **out}
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        graph.replay()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return {"device_ms": start.elapsed_time(end) / iters,
            "clock": "CUDA-graph replays under CUDA events (the trace "
                     "held no device time)",
            **out, "host_enqueue_ms_replay": host * 1e3 / iters}


def phase_flash_time(cfg: dict, device: torch.device, card: dict) -> dict:
    """Kernels 4, 5 and 6 at the train phase's attention shape (B 4,
    H 8, T 2048, D 64, bf16, causal): each kernel's time on the device's
    clock (`device_time` over cfg["flash_iters"] calls; CUDA events over
    as many back-to-back launches beside it), its plain version and its
    bound. The library yardstick is F.scaled_dot_product_attention
    (forward for kernel 4; its backward, which gives dq, dk and dv in one
    call, beside kernels 5 + 6) on the same clock, with the host's
    enqueue time beside each and the SDPA backend named from its
    kernels."""
    cuda = device.type == "cuda"
    b, t, h, d = cfg["flash_time"]
    dtype = torch.bfloat16 if cuda else torch.float32
    q, k, v, do = _flash_inputs(b, t, h, h, d, dtype, device, SEED + 11)
    kw = dict(scale=d ** -0.5, causal=True)
    o, lse = flash.flash_fwd(q, k, v, **kw)
    pairs = int(flash.visible_pairs(b, t, t, True, None, device=device)
                .sum()) * b * h
    info = dict(batch=b, t=t, heads=h, d=d, causal=True,
                visible_pairs=pairs)
    iters = cfg["flash_iters"]
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    leaves = [x.clone().requires_grad_(True) for x in (qh, kh, vh)]
    oh = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                          is_causal=True)
    launches = {
        "flash_fwd": lambda: flash.flash_fwd(q, k, v, **kw),
        "flash_dq": lambda: flash.flash_dq(q, k, v, o, lse, do, **kw),
        "flash_dkv": lambda: flash.flash_dkv(q, k, v, o, lse, do, **kw),
        "sdpa_fwd": lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True),
        "sdpa_bwd": lambda: torch.autograd.grad(oh, leaves, doh,
                                                retain_graph=True)}
    dev = {n: device_time(fn, iters, cuda) for n, fn in launches.items()}
    for n in ("sdpa_fwd", "sdpa_bwd"):
        dev[n]["backend"] = sdpa_backend(dev[n]["kernels"])
    emit({"phase": "flash_device_time", **info, "iters": iters,
          "device": card["kind"], "nvidia_smi": card["smi"], **dev})
    sdpa_fwd, sdpa_bwd = dev["sdpa_fwd"]["device_ms"], \
        dev["sdpa_bwd"]["device_ms"]
    plain = {
        "flash_fwd": lambda: flash.flash_fwd_reference(q, k, v, **kw),
        "flash_dq": lambda: flash.flash_dq_reference(q, k, v, o, lse, do,
                                                     **kw),
        "flash_dkv": lambda: flash.flash_dkv_reference(q, k, v, o, lse, do,
                                                       **kw)}
    which = {"flash_fwd": "fwd", "flash_dq": "dq", "flash_dkv": "dkv"}
    out = {}
    for name in FLASH_KERNELS:
        lib = sdpa_fwd if name == "flash_fwd" else sdpa_bwd
        out[name] = _timed(
            name, launches[name], plain[name],
            flash_cost(q, k, pairs, which[name]), dtype, cfg, cuda, card,
            library_ms=lib, iters=iters, **info,
            device_ms=dev[name]["device_ms"],
            clock=dev[name]["clock"],
            host_enqueue_ms=dev[name]["host_enqueue_ms"],
            library=dev["sdpa_fwd" if name == "flash_fwd" else "sdpa_bwd"])
    emit({"phase": "kernel_time", "kernel": "flash_dq+flash_dkv",
          "ms": out["flash_dq"]["ms"] + out["flash_dkv"]["ms"],
          "device_ms": (None if not cuda else dev["flash_dq"]["device_ms"]
                        + dev["flash_dkv"]["device_ms"]),
          "bound_ms": out["flash_dq"]["bound_ms"]
          + out["flash_dkv"]["bound_ms"],
          "library_ms": sdpa_bwd, "note": SDPA_BWD, **info,
          "device": card["kind"], "nvidia_smi": card["smi"]})
    return out


def lm_loss(module, batch, generator, training):
    """Mean fused cross-entropy over the pre-head hidden states, the
    head weights cast to the model's dtype (examples/train_causal_lm.py)."""
    inp, tgt = batch
    hid = module(inp, return_hidden=True, generator=generator)
    w, bias = module.head_weights()
    return linear_cross_entropy(
        hid, w.to(hid.dtype), tgt,
        None if bias is None else bias.to(hid.dtype)).mean(), {}


def _lm_batches(cfg: dict, n: int, batch: int, device: torch.device,
                seed: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(x).to(device) for x in
                  lm_stream(rng, batch, cfg["train_seq"], cfg["vocab"]))
            for _ in range(n)]


def _lm(cfg: dict, tree: dict, dtype: torch.dtype,
        device: torch.device) -> CausalLM:
    model = CausalLM(vocab=cfg["vocab"], max_len=cfg["max_len"], dtype=dtype,
                     device=device, **cfg["lm"])
    return load_jax_params(model, tree)


def phase_train(cfg: dict, tree: dict, device: torch.device,
                card: dict) -> dict:
    """The training path: `Trainer` with Adam (lr cfg["train_lr"]) on a
    bf16 CausalLM under the fused cross-entropy on a batch of the
    learnable stream of examples/train_causal_lm.py (next token =
    token + 3 mod V), which trains, as that example does, on one batch
    every step: one warm-up step on another batch, then the counted
    steps. Checks: finite losses that fall; one launch of each flash
    kernel per layer per step and no other launch."""
    cuda = device.type == "cuda"
    steps, batch = cfg["train_steps"], cfg["train_batch"]
    model = _lm(cfg, tree, cfg["dtype"], device)
    trainer = Trainer(model, Adam(model.parameters(), cfg["train_lr"]),
                      lm_loss, seed=SEED)
    warm, fixed = _lm_batches(cfg, 2, batch, device, SEED + 9)
    trainer.train_step(warm)
    _reset_launches()                               # the path's counts
    start_bytes = None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = trainer.train_step(fixed)
        losses.append(float(out["loss"]))           # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    layers = cfg["lm"]["num_layers"]
    launches = _expect_launches(FLASH_KERNELS, steps, layers, cuda)
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    tokens = batch * cfg["train_seq"]
    med = float(np.median(step_ms))
    out = {"steps": steps, "batch": batch, "seq": cfg["train_seq"],
           "dtype": str(cfg["dtype"]).replace("torch.", ""),
           "lr": cfg["train_lr"], "losses": losses,
           "step_ms": step_ms, "step_ms_median": med,
           "tokens_per_s": tokens / med * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           # held before the first counted step (weights, Adam slots, and
           # whatever the earlier phases left allocated)
           "allocated_at_start_bytes": start_bytes,
           "kernel_launches": launches, "layers": layers,
           "device": card["kind"], "nvidia_smi": card["smi"]}
    emit({"phase": "train", **out})
    if cuda:
        emit({"phase": "train_profile", **step_profile(trainer, fixed, med),
              "device": card["kind"], "nvidia_smi": card["smi"]})
    return out


def step_profile(trainer, batch, step_ms: float) -> dict:
    """One more training step under `torch.profiler` (after the counted
    steps; its launches are not counted): the card's busy time in the
    step by kernel group, and the idle share against the median
    unprofiled step `step_ms`."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(trainer.train_step(batch)["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    by_group = dict.fromkeys(list(TENSOR_CORE_KERNELS) + ["gemm", "other"],
                             0.0)
    for name, us in events.items():
        low = name.lower()
        group = next((g for g, key in TENSOR_CORE_KERNELS.items()
                      if key in name), None)
        if group is None:
            group = ("gemm" if any(k in low for k in GEMM_NAME_KEYS)
                     else "other")
        by_group[group] += us / 1e3
    busy = sum(by_group.values())
    top = sorted(events.items(), key=lambda kv: -kv[1])[:8]
    return {"device_busy_ms": busy, "step_ms_median": step_ms,
            "idle_share": 1.0 - busy / step_ms,
            "profiled_step_wall_ms": wall, "busy_ms_by_group": by_group,
            "top_kernels_ms": {n[:120]: us / 1e3 for n, us in top},
            "clock": "torch.profiler device time"}


@contextlib.contextmanager
def plain_flash():
    """FlashCore through the plain versions on the card: the oracle of
    train_vs_plain. The kernels come back on exit."""
    saved = (flash.flash_fwd, flash.flash_dq, flash.flash_dkv)
    flash.flash_fwd = flash.flash_fwd_reference
    flash.flash_dq = flash.flash_dq_reference
    flash.flash_dkv = flash.flash_dkv_reference
    try:
        yield
    finally:
        flash.flash_fwd, flash.flash_dq, flash.flash_dkv = saved


@contextlib.contextmanager
def dense_attention():
    """`mha` through its dense reference path on the card (softmax over
    masked einsum scores): train_vs_plain's control, another float32
    order of the same attention with no flash code at all."""
    saved = attention.would_use_flash
    attention.would_use_flash = lambda *args, **kwargs: False
    try:
        yield
    finally:
        attention.would_use_flash = saved


def _noise_only(plain: dict, dense: dict) -> dict:
    """The tensors whose gradient is 0 up to rounding, by one rule: the
    two runs with no kernel in them (flash's plain versions, and `mha`'s
    dense path) disagree on it by more than half its norm, so float32
    leaves it no digit to hold. The key biases are such: a key bias adds
    the same q.b to every score of a row, which softmax ignores, so their
    exact gradient is 0. Per tensor: its plain gradient's norm and
    largest |w|, and the plain-vs-dense norm gap."""
    out = {}
    for n, w in plain.items():
        norm, gap = float(w.norm()), float((dense[n] - w).norm())
        if gap > 0.5 * norm:
            out[n] = {"norm": norm, "max_abs": float(w.abs().max()),
                      "dense_vs_plain_norm": gap}
    return out


def _grad_gap(got: dict, want: dict, skip) -> dict:
    """Per tensor, |g - w| over its bar 1e-2 |w| + 1e-6 * (the largest
    |w| of the model) * sqrt(size), in norm: the worst ratio, its tensor
    and that tensor's |g - w| / |w|; and, over the tensors not in `skip`
    (0 up to rounding), the worst elementwise |g - w| over its tensor's
    largest |w|, and its tensor."""
    top = max(float(w.abs().max()) for w in want.values())
    out = {"grad_worst_over_bar": 0.0, "grad_worst_param": None,
           "grad_worst_norm_rel_err": 0.0,
           "grad_worst_elem_err_over_tensor_max": 0.0,
           "grad_worst_elem_param": None}
    for n, w in want.items():
        diff = float((got[n] - w).norm())
        r = diff / (1e-2 * float(w.norm()) + 1e-6 * top * w.numel() ** 0.5)
        if r > out["grad_worst_over_bar"]:
            out.update(grad_worst_over_bar=r, grad_worst_param=n,
                       grad_worst_norm_rel_err=diff / float(w.norm()))
        elem = float((got[n] - w).abs().max()) / float(w.abs().max())
        if n not in skip and elem > out["grad_worst_elem_err_over_tensor_max"]:
            out.update(grad_worst_elem_err_over_tensor_max=elem,
                       grad_worst_elem_param=n)
    return out


def phase_train_vs_plain(cfg: dict, tree: dict,
                         device: torch.device) -> None:
    """One f32 Trainer step at full width through the kernels, and the
    same step (same weights, same batch) through their plain versions on
    the card, and a control through `mha`'s dense reference path. The
    runs differ only in the attention's float32 summation order. The
    loss must agree within 1e-4 relative, and every gradient within 1e-2
    of its norm plus a floor of 1e-6 of the model's largest gradient
    per element (the key biases' gradient is 0 in exact arithmetic, so
    float32 noise on every side), for the kernels and for the control
    alike. Why a norm bar, and why 1e-2: where an FFN pre-activation
    lies within float32 noise of 0, two runs take the ReLU on opposite
    sides, which moves one token's whole contribution to every gradient
    below it (the phase counts these flips). The control, with no flash
    code, must land within the same bar, so the bar holds float32's own
    spread and no more; a kernel fault (a mask, the scale, a dropout bit)
    moves every gradient by O(1). The tight oracle of each kernel is
    flash_vs_plain's, per kernel output."""
    cuda = device.type == "cuda"
    batch = _lm_batches(cfg, 1, cfg["tvp_batch"], device, SEED + 10)[0]
    layers = cfg["lm"]["num_layers"]
    runs = {}
    for name, ctx, launched in (
            ("kernels", contextlib.nullcontext(), 1),
            ("plain", plain_flash(), 0), ("dense", dense_attention(), 0)):
        model = _lm(cfg, tree, torch.float32, device)
        trainer = Trainer(model, Adam(model.parameters(), cfg["train_lr"]),
                          lm_loss, seed=SEED)
        gates = []
        hooks = [blk.ffn.fc1.register_forward_hook(
            lambda mod, inp, out: gates.append(out.detach() > 0))
            for blk in model.blocks]
        _reset_launches()
        with ctx:
            loss = float(trainer.train_step(batch)["loss"])
        for hook in hooks:
            hook.remove()
        _expect_launches(FLASH_KERNELS, launched, layers, cuda)
        runs[name] = (loss, {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}, gates)
        del model, trainer
    lp, gp, mp = runs["plain"]
    noise = _noise_only(gp, runs["dense"][1])
    out = {}
    for name in ("kernels", "dense"):
        loss, grads, gates = runs[name]
        out[name] = {"loss": loss, "loss_rel_err": abs(loss - lp) / abs(lp),
                     **_grad_gap(grads, gp, noise),
                     "relu_gate_flips": sum(int((a != b).sum())
                                            for a, b in zip(gates, mp))}
    ok = all(r["loss_rel_err"] <= 1e-4 and r["grad_worst_over_bar"] <= 1.0
             for r in out.values())
    emit({"phase": "train_vs_plain", "dtype": "float32",
          "batch": cfg["tvp_batch"], "seq": cfg["train_seq"],
          "loss_plain": lp, "kernels_vs_plain": out["kernels"],
          "control_dense_vs_plain": out["dense"], "grad_bar": 1e-2,
          "grad_max_abs": max(float(w.abs().max()) for w in gp.values()),
          "zero_up_to_rounding": noise, "ok": ok})
    for name, r in out.items():
        check(r["loss_rel_err"] <= 1e-4,
              f"train step loss {name} {r['loss']} vs plain {lp}")
        check(r["grad_worst_over_bar"] <= 1.0,
              f"{name}: gradient {r['grad_worst_param']} off by "
              f"{r['grad_worst_over_bar']} x its bar")

# -- the dense KV-cache path, checkpoints and the optimizers ---------------

def _logit_gap(got: torch.Tensor, want: torch.Tensor, bar: float) -> dict:
    """|got - want| against the bar `bar` absolute plus `bar` relative:
    the worst ratio (<= 1 passes) and the largest absolute gap."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return {"max_abs_err": float(diff.max()),
            "worst_over_bar": float((diff / (bar + bar * w.abs())).max())}


def _top2_gap(logits: torch.Tensor) -> torch.Tensor:
    """Per row, the largest logit minus the second largest."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


@contextlib.contextmanager
def recorded_engine_gaps(gaps: Dict[Tuple[int, int], float]):
    """While open, every token the engine samples records its logits'
    top-2 gap under (request id, position). The sampling is unchanged."""
    saved = engine_mod._sample

    def sample(logits, req, pos):
        top = np.sort(logits.astype(np.float32))[-2:]
        gaps[(req.req_id, pos)] = float(top[1] - top[0])
        return saved(logits, req, pos)

    engine_mod._sample = sample
    try:
        yield
    finally:
        engine_mod._sample = saved


def _stream_split(gen: List[int], eng: List[int], gen_gaps: List[float],
                  eng_gaps: List[float], tie: float) -> dict:
    """How far two greedy streams agree: the tokens equal before the
    first difference, the first position where either path's top-2
    logits lie within `tie`, and whether the streams agree up to it."""
    split = next((i for i, (a, b) in enumerate(zip(gen, eng)) if a != b),
                 None)
    near = next((i for i, (a, b) in enumerate(zip(gen_gaps, eng_gaps))
                 if min(a, b) < tie), None)
    ok = split is None or (near is not None and near <= split)
    return {"agreed": len(gen) if split is None else split,
            "first_near_tie": near, "ok": ok,
            "gap_at_split": (None if split is None else
                             min(gen_gaps[split], eng_gaps[split]))}


def phase_generate(cfg: dict, tree: dict, device: torch.device,
                   card: dict) -> dict:
    """The dense KV-cache path at full width, f32 (bar 1e-4) and bf16
    (bar 2e-2), absolute plus relative:
    - `generate` on B prompts at each length of cfg["gen"]["lens"] with
      `new` tokens each: the flash forward launches once per layer per
      prefill call and a decode step launches no kernel of the port;
      tokens/s over both calls, and one prefill's ms;
    - the prefill's logits through kernel 4 against the same prefill
      under `plain_flash()`; each decode step's logits (a `prefill` and
      `decode_step` loop over generate's own tokens, whose argmaxes must
      be generate's tokens) against `CausalLM.forward` over the same
      tokens (kernel 4 again);
    - `prefill_paged` over the right-padded batch of cfg["gen"]
      ["paged_lens"] against `prefill` run on each prompt alone;
    - f32 only: generate's greedy streams against a `ServeEngine`'s on
      the same weights and prompts (kernel 1 there): they must agree up
      to the first position where either path's top-2 logits lie within
      1e-4."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gcfg = cfg["gen"]
    b, lens, new = gcfg["batch"], gcfg["lens"], gcfg["new"]
    layers = cfg["lm"]["num_layers"]
    rng = np.random.default_rng(SEED + 20)
    prompts = {t0: torch.from_numpy(rng.integers(
        0, cfg["vocab"], (b, t0))).to(device) for t0 in lens}
    paged_lens = gcfg["paged_lens"]
    paged_prompts = [rng.integers(0, cfg["vocab"], n) for n in paged_lens]
    out = {}
    for dtype, bar in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        name = str(dtype).replace("torch.", "")
        model = _lm(cfg, tree, dtype, device)
        model.generate(prompts[lens[0]][:, :8], 2)   # warm-up
        _reset_launches()                               # the path's counts
        sync()
        t0 = time.perf_counter()
        toks = {t: model.generate(p, new) for t, p in prompts.items()}
        sync()
        wall = time.perf_counter() - t0
        launches = _expect_launches("flash_fwd", len(lens), layers, cuda)
        res = {"batch": b, "prompt_lens": list(lens), "new_tokens": new,
               "wall_s": wall, "tokens_per_s": b * new * len(lens) / wall,
               "kernel_launches": launches, "bar": bar}
        gen_gaps = {}
        with torch.no_grad():
            for t, p in prompts.items():
                caches = model.init_cache(b, t + new)
                _reset_launches()
                logits, caches = model.prefill(p, caches)
                _expect_launches("flash_fwd", 1, layers, cuda)
                with plain_flash():
                    plain, _ = model.prefill(p, model.init_cache(b, t + new))
                steps = [logits]
                _reset_launches()
                for i in range(t, t + new - 1):
                    lg, caches = model.decode_step(toks[t][:, i], i, caches)
                    steps.append(lg)
                _expect_launches("flash_fwd", 0, layers, cuda)
                steps = torch.stack(steps, dim=1)           # [B, new, V]
                check(torch.equal(steps.argmax(-1), toks[t][:, t:]),
                      f"{name} T0 {t}: generate's tokens are not the "
                      "argmax of its own decode steps")
                dense = model(toks[t][:, :t + new - 1])[:, t - 1:]
                res[f"prefill_vs_plain_T{t}"] = _logit_gap(logits, plain,
                                                           bar)
                res[f"decode_vs_forward_T{t}"] = _logit_gap(steps, dense,
                                                            bar)
                gen_gaps[t] = _top2_gap(steps).cpu()
                check(bool(torch.isfinite(steps).all()),
                      f"{name} T0 {t}: non-finite decode logits")
            if cuda:
                p = prompts[lens[-1]]
                res["prefill_ms"] = time_ms(
                    lambda: model.prefill(p, model.init_cache(b, lens[-1])),
                    iters=10, warmup=2, cuda=True)
            tpad = max(paged_lens)
            padded = torch.zeros((len(paged_lens), tpad), dtype=torch.long)
            for row, pr in enumerate(paged_prompts):
                padded[row, :len(pr)] = torch.from_numpy(pr)
            last = torch.tensor([n - 1 for n in paged_lens])
            _reset_launches()
            paged_logits, kvs = model.prefill_paged(padded.to(device),
                                                    last.to(device))
            solo = torch.cat([model.prefill(
                torch.from_numpy(pr)[None].to(device),
                model.init_cache(1, len(pr)))[0] for pr in paged_prompts])
            _expect_launches("flash_fwd", 1 + len(paged_lens), layers, cuda)
            check(len(kvs) == layers and tuple(kvs[0][0].shape)[:2]
                  == (len(paged_lens), tpad), "prefill_paged k/v shape")
            res["prefill_paged_vs_solo"] = _logit_gap(paged_logits, solo,
                                                      bar)
        for key, gap in res.items():
            if isinstance(gap, dict) and "worst_over_bar" in gap:
                check(gap["worst_over_bar"] <= 1.0,
                      f"generate {name} {key}: {gap} over the bar {bar}")
        if dtype == torch.float32:
            res["engine_streams"] = _generate_vs_engine(
                cfg, model, prompts, toks, gen_gaps, new)
        res.update(device=card["kind"], nvidia_smi=card["smi"])
        emit({"phase": "generate", "dtype": name, **res})
        if cuda:
            emit({"phase": "generate_profile", "dtype": name,
                  **generate_profile(model, prompts[lens[-1]], new),
                  "device": card["kind"], "nvidia_smi": card["smi"]})
        out[name] = res
        del model
        gc.collect()
    return out


def generate_profile(model, prompt: torch.Tensor, new: int) -> dict:
    """One more `generate` call under `torch.profiler` (after the
    counted run; its launches are not counted): the card's busy time by
    kernel group against the call's wall time, and the idle share."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model.generate(prompt, new)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    by_group = {"flash_fwd": 0.0, "gemm": 0.0, "other": 0.0}
    for name, us in events.items():
        low = name.lower()
        group = ("flash_fwd" if ("fwd_kernel" in name
                                 or TENSOR_CORE_KERNELS["flash_fwd"] in name)
                 else "gemm" if any(k in low for k in GEMM_NAME_KEYS)
                 else "other")
        by_group[group] += us / 1e3
    busy = sum(by_group.values())
    top = sorted(events.items(), key=lambda kv: -kv[1])[:8]
    return {"prompt_len": prompt.shape[1], "batch": prompt.shape[0],
            "new_tokens": new, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall, "busy_ms_by_group": by_group,
            "top_kernels_ms": {n[:120]: us / 1e3 for n, us in top},
            "clock": "torch.profiler device time"}


def _generate_vs_engine(cfg: dict, model, prompts, toks, gen_gaps,
                        new: int) -> dict:
    """generate's greedy streams against a ServeEngine's on the same f32
    model and prompts (see phase_generate)."""
    engine = ServeEngine(model, block_size=cfg["block_size"],
                         num_blocks=cfg["num_blocks"],
                         max_batch_size=cfg["max_batch"],
                         max_prefill_tokens=cfg["max_prefill"],
                         tile_q=cfg["tile_q"], device=model.device)
    gaps: Dict[Tuple[int, int], float] = {}
    rows = []
    with recorded_engine_gaps(gaps):
        for t, p in prompts.items():
            reqs = [engine.add_request(row.tolist(), max_new_tokens=new)
                    for row in p.cpu()]
            engine.run()
            for i, r in enumerate(reqs):
                eng_gaps = [gaps[(r.req_id, t + k)] for k in range(new)]
                rows.append({"prompt_len": t, "row": i, **_stream_split(
                    toks[t][i, t:].tolist(), r.generated,
                    gen_gaps[t][i].tolist(), eng_gaps, 1e-4)})
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"generate vs engine streams split before a near tie: "
                   f"{bad}")
    return {"rows": len(rows), "tokens_agreed": sum(r["agreed"]
                                                    for r in rows),
            "tokens": new * len(rows),
            "splits": [r for r in rows if r["agreed"] < new]}


def _state_leaves(trainer) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in
            flatten_with_keys(trainer.state())}


def phase_resume(cfg: dict, tree: dict, device: torch.device,
                 card: dict) -> dict:
    """Checkpoint and resume of the train path (bf16 Adam, B x T of
    cfg["resume"], dropout 0): `steps` steps straight; then `split`
    steps, `CheckpointManager.save` (max_to_keep 2, in a temporary
    directory), a model, optimizer and Trainer made anew (random init),
    `restore_latest` + `load_state`, and the remaining steps. The
    resumed run's losses, parameters, slots and step must equal the
    straight run's bit for bit (the flash kernels hold no atomics, and
    the step's generator is derived from (seed, step)); the checkpoint
    must pass `verify_checkpoint`. Times the save, an async save (the
    return, then the write) and the restore."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rcfg = cfg["resume"]
    steps, split = rcfg["steps"], rcfg["split"]
    batches = _lm_batches(cfg, steps, rcfg["batch"], device, SEED + 30)
    layers = cfg["lm"]["num_layers"]

    def trainer(model):
        return Trainer(model, Adam(model.parameters(), cfg["train_lr"]),
                       lm_loss, seed=SEED)

    straight = trainer(_lm(cfg, tree, cfg["dtype"], device))
    want_losses = [straight.train_step(b)["loss"].item() for b in batches]
    want = _state_leaves(straight)
    del straight
    first = trainer(_lm(cfg, tree, cfg["dtype"], device))
    for b in batches[:split]:
        first.train_step(b)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "sync"), max_to_keep=2)
        sync()
        t0 = time.perf_counter()
        path = mgr.save(first.state(), step=first.step)
        save_ms = (time.perf_counter() - t0) * 1e3
        manifest = verify_checkpoint(path)
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        amgr = CheckpointManager(os.path.join(tmp, "async"), max_to_keep=2,
                                 async_save=True)
        sync()
        t0 = time.perf_counter()
        amgr.save(first.state(), step=first.step)
        async_return_ms = (time.perf_counter() - t0) * 1e3
        amgr.wait()
        async_total_ms = (time.perf_counter() - t0) * 1e3
        del first
        gc.collect()
        resumed = trainer(CausalLM(vocab=cfg["vocab"],
                                   max_len=cfg["max_len"], dtype=cfg["dtype"],
                                   device=device, **cfg["lm"]))
        sync()
        t0 = time.perf_counter()
        ts, step = mgr.restore_latest(target=resumed.state())
        resumed.load_state(ts)
        sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
    check(step == split and resumed.step == split,
          f"restored step {step}, trainer step {resumed.step}")
    _reset_launches()                               # the path's counts
    got_losses = [resumed.train_step(b)["loss"].item()
                  for b in batches[split:]]
    launches = _expect_launches(FLASH_KERNELS, steps - split, layers, cuda)
    got = _state_leaves(resumed)
    unequal = sorted(k for k in want if not torch.equal(got[k], want[k]))
    out = {"steps": steps, "saved_at": split, "batch": rcfg["batch"],
           "seq": cfg["train_seq"],
           "dtype": str(cfg["dtype"]).replace("torch.", ""),
           "losses_straight": want_losses,
           "losses_resumed": want_losses[:split] + got_losses,
           "leaves": len(want), "unequal_leaves": unequal,
           "checkpoint_bytes": nbytes,
           "checkpoint_leaves": len(manifest["leaves"]),
           "save_ms": save_ms, "async_save_return_ms": async_return_ms,
           "async_save_total_ms": async_total_ms, "restore_ms": restore_ms,
           "kernel_launches": launches, "device": card["kind"],
           "nvidia_smi": card["smi"]}
    emit({"phase": "resume", **out})
    check(got_losses == want_losses[split:],
          f"resumed losses {got_losses} != {want_losses[split:]}")
    check(not unequal, f"resumed state differs at {unequal[:5]}")
    return out


OPTIMIZER_CASES = {
    "SGD": (0.05, {}), "Momentum": (0.05, dict(use_nesterov=True)),
    "LarsMomentum": (0.5, dict(lars_coeff=0.1)),
    "Adagrad": (0.05, dict(initial_accumulator_value=0.1)),
    "DecayedAdagrad": (0.05, {}), "Adam": (0.01, {}), "AdamW": (0.01, {}),
    "Adamax": (0.01, {}), "Adadelta": (1.0, {}),
    "RMSProp": (0.01, dict(centered=True, momentum=0.5)),
    "Ftrl": (0.05, dict(l1=0.01, l2=0.02)),
    "ProximalGD": (0.05, dict(l1=0.01, l2=0.02)),
    "ProximalAdagrad": (0.05, dict(l1=0.01, l2=0.02)),
    "Lamb": (0.01, {}),
}


def phase_optimizers(cfg: dict, device: torch.device) -> None:
    """Each of the fourteen optimizers (with a global-norm clip) and
    `ModelAverage`: 3 steps on card tensors against the same code on the
    CPU, the parameters and every slot within 1e-6 of each tensor's
    largest magnitude (reductions sum in other orders)."""
    rng = np.random.default_rng(SEED + 40)
    shapes = cfg["optim_shapes"]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(2 * rng.standard_normal(s)).astype(np.float32)
              for s in shapes] for _ in range(3)]

    def run(name, dev):
        lr, kw = OPTIMIZER_CASES[name]
        params = [torch.nn.Parameter(torch.tensor(x, device=dev))
                  for x in init]
        opt = getattr(optim, name)(params, lr, grad_clip=("global_norm",
                                                          10.0), **kw)
        for step in grads:
            for p, g in zip(params, step):
                p.grad = torch.from_numpy(g).to(dev)
            opt.step()
        return [p.detach().cpu() for p in params] + [
            opt.state[p][s].cpu() for p in params for s in opt.SLOTS]

    worst = {}
    for name in OPTIMIZER_CASES:
        errs = [float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
                for g, w in zip(run(name, device), run(name, "cpu"))]
        worst[name] = max(errs)
    avg = optim.ModelAverage(decay=0.9)
    card_avg = avg.init(torch.tensor(x, device=device) for x in init)
    cpu_avg = avg.init(torch.tensor(x) for x in init)
    for step in grads:
        avg.update(card_avg, [torch.from_numpy(g).to(device) for g in step])
        avg.update(cpu_avg, [torch.from_numpy(g) for g in step])
    worst["ModelAverage"] = max(
        float((a.cpu() - b).abs().max() / b.abs().max())
        for a, b in zip(card_avg, cpu_avg))
    emit({"phase": "optimizers", "device_vs_cpu_rel_err": worst,
          "bar": 1e-6, "shapes": [list(s) for s in shapes],
          "ok": max(worst.values()) <= 1e-6})
    bad = {k: v for k, v in worst.items() if v > 1e-6}
    check(not bad, f"optimizers on the card vs the CPU: {bad}")


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
        split_prompts=(40, 23), split_steps=4,
        # flash checks and times (B, T, H, D): the train phase's attention
        flash_check=(4, 2048, 8, 64), flash_time=(4, 2048, 8, 64),
        flash_iters=400,
        # train: B 4 x T 2048 bf16, Adam at the lr of
        # examples/train_causal_lm.py; train_vs_plain: one f32 step
        train_steps=10, train_batch=4, train_seq=2048, train_lr=3e-3,
        tvp_batch=4,
        # generate: B 8 at two prompt lengths, 64 new tokens each;
        # prefill_paged over 8 prompts of 300-512 right-padded
        gen=dict(batch=8, lens=(300, 512), new=64,
                 paged_lens=[300 + 30 * i for i in range(7)] + [512]),
        # resume: the train phase's batch, bf16 Adam, saved after 3 of 6
        resume=dict(steps=6, split=3, batch=4),
        optim_shapes=[(512, 512), (2048,), (8, 64, 64)],
        # engine_spec: 8 greedy prompts of 256 repeating a 48-token span
        # and two n=4 groups, 32 new tokens each, spec_k 4
        spec=dict(k=4, span=48, prompt=256, new=32, groups=2, n=4,
                  eager_new=8),
        # engine_tier: 8 prompts of 200 (13 blocks each) on 109 usable
        # blocks, so decode growth past position 208 preempts decoding
        # sequences; two filler waves recycle the cached-free blocks; a
        # 256 MB host tier holds them all
        tier=dict(prompt=200, new=32, num_blocks=110, roomy_blocks=1024,
                  bytes=256 << 20, compress_blocks=32, filler_waves=2))


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
        split_prompts=(20, 13), split_steps=3,
        flash_check=(2, 40, 8, 8), flash_time=(1, 48, 8, 8), flash_iters=2,
        train_steps=10, train_batch=2, train_seq=32, train_lr=3e-3,
        tvp_batch=2,
        gen=dict(batch=2, lens=(12, 20), new=6, paged_lens=[12, 16, 20]),
        resume=dict(steps=4, split=2, batch=2),
        optim_shapes=[(4, 4), (6,)],
        spec=dict(k=4, span=12, prompt=40, new=8, groups=2, n=2,
                  eager_new=4),
        tier=dict(prompt=40, new=20, num_blocks=14, roomy_blocks=64,
                  bytes=16 << 20, compress_blocks=4, filler_waves=2))


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
    tensor_cores = phase_build(cfg, cuda)
    errs = phase_kernel_vs_plain(cfg, device)
    phase_mixed_vs_promote(cfg, device)
    errs.update(phase_flash_vs_plain(cfg, device))
    timing = phase_kernel_time(cfg, device, card)
    timing.update(phase_flash_time(cfg, device, card))
    lm = cfg["lm"]
    tree = causal_lm_tree(SEED, cfg["vocab"], lm["model_dim"],
                          lm["num_heads"], lm["num_layers"], lm["ffn_dim"])
    phase_step_vs_dense(cfg, tree, device)
    phase_graph_vs_eager(cfg, tree, device, card)
    paths = {"ragged_paged_attention": phase_engine(cfg, tree, device, card),
             "ragged_paged_attention_mixed": phase_engine_int8(
                 cfg, tree, device, card)}
    spec = phase_engine_spec(cfg, tree, device, card)
    phase_engine_tier(cfg, tree, device, card)
    paths["paged_attention"] = phase_split_path(cfg, tree, device, card)
    train = phase_train(cfg, tree, device, card)
    paths.update(dict.fromkeys(FLASH_KERNELS, train))
    phase_train_vs_plain(cfg, tree, device)
    generate = phase_generate(cfg, tree, device, card)
    phase_resume(cfg, tree, device, card)
    phase_optimizers(cfg, device)

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
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "tensor_cores": tensor_cores.get(name, False)})
        if name == "ragged_paged_attention":
            rows[-1]["launches_spec"] = \
                spec["float32"]["kernel_launches"][name]
        if name == "flash_fwd":
            rows[-1]["launches_generate"] = {
                dt: r["kernel_launches"][name] for dt, r in generate.items()}
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
