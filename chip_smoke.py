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
- `files`: the same bf16 model trained straight from two slot files by
  `train_from_files` (the native DataFeed, built with g++ from the
  checkout, parsing on two threads; `to_padded`; `device_prefetch`) —
  the flash kernels again, from file-fed batches that must equal the
  written rows; then RecordIO files written and read back natively, a
  DLPack round trip and `memory_stats` on the card;
- `profile`: 3 more `train` steps under the port's profiler
  (`start_profiler(trace_dir)`): `Trainer.train_step` in the host table
  once a step, `op_table(by="category")` listing the flash kernels'
  operators at one launch a layer a step, an `annotate` region on the
  device timeline, the table's device ms beside `train`'s step; a short
  engine wave whose merged trace carries the host spans;
- `selfcheck`: `flash_selfcheck()` at JAX's defaults (B 2, H 4, T 1024,
  D 64, bf16, causal) with its launch counts;

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
- `engine_tp` (f32): `ServeEngine.from_saved_model(..., tp_size=2)` —
  rank 0 in this process, rank 1 a worker process; on one card both
  ranks share it over gloo, on two cards each has its own over NCCL —
  serving the `engine` phase's traffic in `fp` and `int8` allreduce
  mode beside a tp=1 engine, then `engine_int8`'s traffic with the
  in-device int8 tier: kernels 1 and 2 on every rank, at each rank's 4
  query heads over 4 kv heads;
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
  `ModelAverage` on the card against the CPU;
- `bert`: BERT-base MLM pretraining (`BertEncoder`, bf16, B 32 x T 128
  with padding as segment ids) — the flash kernels non-causal; one f32
  step at 2 layers held against their plain versions;
- `seq2seq`: Transformer-base WMT training (bf16, B 16 x T 256, source
  padding as segment ids) — the flash kernels in the encoder and the
  decoder's causal self-attention — then, in f32, `beam_search` over
  `decode_step` and greedy decoding through `decode_step` and
  `decode_step_paged` (the paged-decode kernel);
- `ops_sweep`: every case of `paddle_tpu_torch.testing.op_cases` (the
  control flow, lattices, extras, detection ops and metrics, no kernel
  of their own) on the card against the CPU, then `multiclass_nms` at
  SSD300's detection-output settings over its 8,732 priors and
  `ctc_loss` forward and backward over DeepSpeech2's 29-symbol alphabet
  (B 32 x T 400), each timed on the device clock with its launches;
- `zoo`: the nn layers (no kernel of their own: cuDNN's convolutions
  and PyTorch's ops) on the card against the CPU, every case of
  `paddle_tpu_torch.testing.nn_cases` and one ResNet((1, 1, 1, 1))
  training step; ResNet-50 training at the repo's `resnet50` spec
  (224x224, B 64, bf16, Momentum), timed and traced, beside its FLOP
  bound, with a float32 run and a small-lr bf16 run from the same
  weights as its witness; the stacked-LSTM classifier at its `stacked_lstm` spec (B 64
  x T 100, f32, Adam);
- `quant`: every case of `paddle_tpu_torch.testing.quant_cases` (the
  fake-quant ops, `int8_matmul`, the int8 and QAT layers; no kernel of
  their own: the int8 GEMMs are `torch._int_mm`) on the card against the
  CPU; ResNet-50 inference at bench.py's `_int8_compute_bench` spec
  (224x224, B 16 and 128) in float32, bf16 and int8 frozen by
  `freeze_int8` (dynamic, and static from one calibration batch), timed,
  with the int8 variants' agreement and logit error against bf16; the
  int8 LM head at [4096, 512] x [512, 32000] against bf16;
- `export`: `save_inference_model` + `InferencePredictor` on the card:
  ResNet-50 (B 16, f32) against the in-process module; BERT-base's
  forward (B 8 x T 128 with lengths), whose exported graph launches
  kernel 4 through its operator, once a layer; a CausalLM export at the
  LM configuration with its `serve` block, served by
  `ServeEngine.from_saved_model` with an in-memory engine's streams;
  between the two, `cabi` serves the BERT export through serving/'s C
  ABI (`CPredictor` on the card against `InferencePredictor`, kernel 4
  once a layer a call), the C++ demo and the C++ training program, and
  4 clones at once (JAX's bar: 0.5x the serial calls a second);
- `book`: LeNet on the seeded synthetic MNIST through the `data`
  readers and `device_prefetch`, 3 epochs, checkpoint restore, export
  and `freeze_int8`, test accuracy > 0.7 in float and int8;
- `benchmark`: `paddle_tpu_torch.benchmark`, as its CLI calls it:
  `run_model("transformer")` and `run_model("lm_longctx")` in bf16 for
  a short timed window each (kernels 4-6 a layer a step, counted), and
  `run_infer` on the CausalLM through a ServeEngine over fp KV pools
  (kernel 1) and with the in-device int8 tier (kernel 2), each
  BenchResult printed beside the card's name and power limit;
- `mesh_train`: `MeshTrainer` over ranks of `parallel/launch.py` (one
  process a rank; on one card the ranks share it over gloo): the LM at
  dp=2, at fsdp=2 (ZeRO under REDUCE) and at tp=2 (Megatron: the flash
  kernels at each rank's 4 heads), each in f32 at 2 layers and bf16 at
  full depth against a single-rank run of the whole batch, then dp=2 x
  fsdp=2 on 4 ranks saving a sharded checkpoint that a fresh world
  resumes bit for bit;
- `mesh_parallel`: the sp, pp and ep axes over ranks sharing the card:
  ring flash attention (causal contiguous, causal zig-zag, non-causal)
  and Ulysses at the LM's long-context width (B 1 x T 16384, 8 heads of
  64, bf16) on sp=2, forward and backward — kernels 4, 5 and 6 on each
  ring block — against one rank's flash on the whole sequence;
  `PipelinedLM` at the LM's widths (6 stages, f32) on pp=2 under GPipe
  and 1F1B against one rank's dense Adam steps; the MoE FFN at bench.py's
  shape (E 8, D 1024, hidden 4096, 8192 tokens, bf16, top-2) on ep=2,
  masked and all_to_all at three capacity factors, against one rank; a
  `PipelinedMoELM` on pp=2 x ep=2.

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
import copy
import dataclasses
import gc
import gzip
import itertools
import json
import logging
import shutil
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import (data, optim, profiler, quant, recordio,
                              serving)
from paddle_tpu_torch import benchmark as bench
from paddle_tpu_torch.benchmark.models import run_infer
from paddle_tpu_torch.core import Trainer, supervised_loss, train_from_files
from paddle_tpu_torch.data import write_slot_file
from paddle_tpu_torch.engine import HostKVTier, ServeEngine
from paddle_tpu_torch.engine import engine as engine_mod
from paddle_tpu_torch.engine.tp_worker import param_bytes
from paddle_tpu_torch.io import (CheckpointManager, InferencePredictor,
                                 load_checkpoint, save_inference_model,
                                 verify_checkpoint)
from paddle_tpu_torch.kernels import attention, build, flash
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.kernels.selfcheck import (EXPECTED_LAUNCHES,
                                                flash_selfcheck)
from paddle_tpu_torch.metrics import accuracy
from paddle_tpu_torch.models import (BertEncoder, CausalLM, LeNet, ResNet,
                                     TextClassifier, Transformer,
                                     load_jax_params, to_jax_params)
from paddle_tpu_torch.nn.layers import Conv2D, Linear
from paddle_tpu_torch.obs import (DeviceMemoryMonitor, FlightRecorder,
                                  GoodputLedger, MetricsServer,
                                  causal_lm_step_flops, merged_chrome_trace,
                                  param_count)
from paddle_tpu_torch.obs.goodput import PEAK_FLOPS as CARD_PEAK_FLOPS
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.ops import (beam_search, linear_cross_entropy,
                                  softmax_with_cross_entropy, tile_beams)
from paddle_tpu_torch.ops import detection, lattice
from paddle_tpu_torch.ops.sequence import sequence_mask
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.parallel import DistStrategy, MeshTrainer, make_mesh
from paddle_tpu_torch.resilience import PREEMPT_EXIT_CODE, chaos
from paddle_tpu_torch.resilience.supervisor import (RunSupervisor,
                                                    train_resilient)
from paddle_tpu_torch.serve import replica as replica_cli
from paddle_tpu_torch.serve.router import Router
from paddle_tpu_torch.serve.sse import (http_get, parse_prometheus_values,
                                        stream_completion)
from paddle_tpu_torch.quant.int8_compute import Int8Linear, freeze_int8
from paddle_tpu_torch.testing import (nn_cases, one_torch_thread, op_cases,
                                      quant_cases)
from paddle_tpu_torch.testing import mesh_cases as M
from paddle_tpu_torch.testing import parallel_cases as PC
from paddle_tpu_torch.testing import (FLASH_ARGS, PAGED_ARGS, QUANT_ARGS,
                                      RAGGED_ARGS, STEP_ARGS, bert_tree,
                                      causal_lm_tree,
                                      decode_as_ragged, flash_case,
                                      int8_blocks, lm_stream,
                                      pack_prompts, packed_segment_ids,
                                      paged_case, ragged_case,
                                      transformer_tree, write_serving_export)
from paddle_tpu_torch.utils.debug import memory_stats
from paddle_tpu_torch.utils.interop import from_dlpack, to_dlpack
from paddle_tpu_torch.utils.log import add_event_tap, remove_event_tap
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


def write_export(cfg: dict, tree: dict) -> str:
    """Write the seeded weights as a v2 export at EXPORT_DIR (the JAX
    export's layout, with numpy), with the manifest's serve block as
    engine.serve_metadata writes it. Returns the directory."""
    lm = cfg["lm"]
    meta = {"model_type": "causal_lm", "vocab": cfg["vocab"],
            "model_dim": lm["model_dim"], "num_heads": lm["num_heads"],
            "num_kv_heads": lm["num_heads"],
            "head_dim": lm["model_dim"] // lm["num_heads"],
            "num_layers": lm["num_layers"], "ffn_dim": lm["ffn_dim"],
            "max_len": cfg["max_len"], "tie_embeddings": True,
            "fused_qkv": False}
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    return write_serving_export(str(EXPORT_DIR), tree, meta)


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
    write_export(cfg, tree)
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


# -- tensor-parallel serving -------------------------------------------------

_RANK_COUNTERS = {"ragged_paged_attention.launches": "ragged_paged_attention",
                  "ragged_paged_attention.mixed_launches":
                      "ragged_paged_attention_mixed",
                  "paged_attention.launches": "paged_attention"}


@contextlib.contextmanager
def allreduce_mode(mode: str):
    """PTPU_SERVE_ALLREDUCE while open (an engine reads it when built)."""
    prev = os.environ.get("PTPU_SERVE_ALLREDUCE")
    os.environ["PTPU_SERVE_ALLREDUCE"] = mode
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("PTPU_SERVE_ALLREDUCE", None)
        else:
            os.environ["PTPU_SERVE_ALLREDUCE"] = prev


def _tp_ranks(cuda: bool, tp: int):
    """(device argument, data-plane backend, why) of the tp engines."""
    if not cuda:
        return "cpu", "gloo", "CPU rehearsal: every rank on the CPU"
    n = torch.cuda.device_count()
    if n >= tp:
        return None, "nccl", f"{n} cards: each rank on its own card"
    return (["cuda:0"] * tp, "gloo",
            f"{n} card: the {tp} ranks share cuda:0, where NCCL refuses "
            "two ranks on one device, so the data plane is gloo through "
            "host memory; the NCCL path stays unrun on this machine")


def _rank_launches(eng, kernel: str, layers: int, cuda: bool) -> list:
    """Every rank's kernel launches (the leader's and the workers'
    counters) must be `kernel` once a layer a step, and nothing else."""
    per = []
    for st in eng.rank_state():
        got = {_RANK_COUNTERS[k]: v for k, v in st["launches"].items()}
        want = dict.fromkeys(got, 0)
        if cuda:
            want[kernel] = eng.steps * layers
        check(got == want, f"rank {st['rank']}: launches {got} != {want} "
                           f"({eng.steps} steps x {layers} layers)")
        per.append(got)
    return per


def _close_tp(eng) -> List[int]:
    eng.close()
    codes = eng.worker_exit_codes
    check(codes and all(c == 0 for c in codes),
          f"tp workers exited {codes}")
    return codes


def phase_engine_tp(cfg: dict, tree: dict, device: torch.device,
                    card: dict) -> dict:
    """Tensor-parallel serving at full width, f32 from the v2 export:
    `ServeEngine.from_saved_model(..., tp_size=2)` serves the `engine`
    phase's traffic (two waves on a shared prefix) in `fp` and then
    `int8` allreduce mode, beside a tp=1 engine on the same weights and
    traffic; then `engine_int8`'s traffic with the in-device int8 tier,
    direct reads against promotions. Checks: fp streams equal tp=1's up
    to the first near tie (top-2 logits within 1e-4 on either engine;
    splits counted); int8 completes every request; kernel 1 (kernel 2
    with the tier) launches once a layer a step on EACH rank and nothing
    else launches; a rank holds half of tp=1's pool bytes and a weight
    shard smaller than the model (the same on each rank); the int8
    scales are equal on both ranks; direct-read streams equal the
    promote path's; one program (`ptpu_engine_compiles` 1) on every
    rank; the workers exit 0. Times are the host clock around the
    synchronised drains; the allreduce probe is the engine's own."""
    cuda = device.type == "cuda"
    tp = cfg["tp"]["size"]
    devs, backend, why = _tp_ranks(cuda, tp)
    layers = cfg["lm"]["num_layers"]
    if not (EXPORT_DIR / "signature.json").exists():
        write_export(cfg, tree)
    kw = dict(block_size=cfg["block_size"], num_blocks=cfg["num_blocks"],
              max_batch_size=cfg["max_batch"],
              max_prefill_tokens=cfg["max_prefill"], tile_q=cfg["tile_q"])
    rng = np.random.default_rng(SEED + 3)          # the engine phase's
    vocab, n_new = cfg["vocab"], cfg["max_new"]
    prefix = rng.integers(0, vocab, cfg["prefix"]).tolist()
    lens1 = [cfg["long_prompt"] - cfg["prefix"]] + [
        16 + 9 * i for i in range(cfg["max_batch"] - 1)]
    wave1 = [prefix + rng.integers(0, vocab, n).tolist() for n in lens1]
    wave2 = [prefix + rng.integers(0, vocab, 5 + 7 * i).tolist()
             for i in range(cfg["max_batch"])]

    def serve(eng):
        gaps: Dict[Tuple[int, int], float] = {}
        with recorded_engine_gaps(gaps):
            t0 = time.perf_counter()
            reqs = [eng.add_request(p, max_new_tokens=n_new) for p in wave1]
            eng.run()
            reqs += [eng.add_request(p, max_new_tokens=n_new) for p in wave2]
            eng.run()
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        toks = [r.generated for r in reqs]
        rgaps = [[gaps[(r.req_id, len(r.prompt) + i)] for i in range(n_new)]
                 for r in reqs]
        ttft = sorted((r.first_token_time - r.enqueue_time) * 1e3
                      for r in reqs)
        for r in reqs:
            check(r.finish_reason == "length" and len(r.generated) == n_new,
                  f"request {r.req_id} ended {r.finish_reason!r} after "
                  f"{len(r.generated)} tokens")
        return toks, rgaps, {
            "steps": eng.steps, "wall_s": wall,
            "step_ms": wall * 1e3 / eng.steps,
            "tokens_per_s": n_new * len(reqs) / wall,
            "ttft_p50_ms": float(np.median(ttft))}

    ref = ServeEngine.from_saved_model(str(EXPORT_DIR), device=device,
                                       registry=MetricsRegistry(), **kw)
    ref.generate([[1, 2, 3]], max_new_tokens=2)     # warm-up
    ref.reset_stats()
    want, want_gaps, ref_out = serve(ref)
    ref_bytes = ref.cache.per_chip_pool_bytes()
    ref_params = param_bytes(ref.model)
    out = {"tp": tp, "backend": backend, "why": why,
           "ranks": ([str(d) for d in devs] if isinstance(devs, list)
                     else [f"cuda:{i}" for i in range(tp)] if devs is None
                     else [devs] * tp),
           "tp1": ref_out, "tp1_pool_bytes": ref_bytes,
           "tp1_param_bytes": ref_params}
    del ref
    gc.collect()

    for mode in ("fp", "int8"):
        with allreduce_mode(mode):
            t0 = time.perf_counter()
            eng = ServeEngine.from_saved_model(
                str(EXPORT_DIR), device=devs, tp_size=tp,
                registry=MetricsRegistry(), **kw)
            build_s = time.perf_counter() - t0
        try:
            check(eng.tp_backend == backend, f"backend {eng.tp_backend} "
                                             f"!= {backend}")
            eng.generate([[1, 2, 3]], max_new_tokens=2)   # warm-up
            eng.reset_stats()
            _reset_launches()                       # the path's counts
            eng.rank_state(reset_launches=True)     # ... on every rank
            got, got_gaps, res = serve(eng)
            res["rank_launches"] = _rank_launches(
                eng, "ragged_paged_attention", layers, cuda)
            _expect_launches("ragged_paged_attention", eng.steps, layers,
                             cuda)
            states = eng.rank_state()
            res["rank_pool_bytes"] = [s["pool_bytes"] for s in states]
            check(all(2 * b == ref_bytes for b in res["rank_pool_bytes"]),
                  f"rank pool bytes {res['rank_pool_bytes']} != half of "
                  f"tp=1's {ref_bytes}")
            # a rank holds its weight shard (the replicated embedding,
            # LayerNorms and fc2 / out_proj biases whole), never the model
            res["rank_param_bytes"] = [s["param_bytes"] for s in states]
            check(len(set(res["rank_param_bytes"])) == 1
                  and res["rank_param_bytes"][0] < ref_params
                  and param_bytes(eng.model) == res["rank_param_bytes"][0],
                  f"rank param bytes {res['rank_param_bytes']}, tp=1's "
                  f"{ref_params}")
            compiles = eng.obs.get("ptpu_engine_compiles").value
            check([s["compiles"] for s in states] == [1] * tp
                  and compiles == 1 and len(eng.step_shapes) == 1,
                  f"programs {[s['compiles'] for s in states]}, gauge "
                  f"{compiles}, {len(eng.step_shapes)} step shapes")
            rows = [_stream_split(w, g, wg, gg, 1e-4) for w, g, wg, gg
                    in zip(want, got, want_gaps, got_gaps)]
            res["streams_equal_tp1"] = sum(w == g for w, g in zip(want, got))
            res["splits"] = [r for r in rows if r["agreed"] < n_new]
            if mode == "fp":
                check(all(r["ok"] for r in rows),
                      f"fp tp streams split from tp=1 before a near tie: "
                      f"{res['splits']}")
            res.update(build_s=build_s, probe_ms=eng._allreduce_probe_ms,
                       requests=len(want), generated_tokens=n_new * len(want))
            eng.cache.assert_quiesced()
        finally:
            codes = _close_tp(eng)
        out[mode] = dict(res, worker_exit_codes=codes)
        del eng
        gc.collect()
    out["int8_tier"] = _engine_tp_tier(cfg, devs, tp, layers, cuda)
    emit({"phase": "engine_tp", **out, "dtype": "float32",
          "device": card["kind"], "nvidia_smi": card["smi"]})
    return out


def _engine_tp_tier(cfg: dict, devs, tp: int, layers: int,
                    cuda: bool) -> dict:
    """engine_int8's traffic on tp=2 engines with the in-device int8
    tier (fp allreduce): wave 1, fillers until the prefix is int8-only,
    wave 2 reading it in place; then the same with kv_promote_hits=1."""
    c = cfg["int8"]
    bs, vocab, n_new = cfg["block_size"], cfg["vocab"], c["max_new"]
    rng = np.random.default_rng(SEED + 7)          # engine_int8's
    prefix = rng.integers(0, vocab, cfg["prefix"]).tolist()
    wave1 = [prefix + rng.integers(0, vocab, 16 + 9 * i).tolist()
             for i in range(cfg["max_batch"])]
    wave2 = [prefix + rng.integers(0, vocab, 5 + 7 * i).tolist()
             for i in range(cfg["max_batch"])]
    fillers = [[rng.integers(0, vocab, c["filler_len"]).tolist()
                for _ in range(cfg["max_batch"])]
               for _ in range(c["max_filler_waves"])]
    head = tuple(prefix[:bs])
    runs = {}
    for name, hits in (("direct", 0), ("promote", 1)):
        _reset_launches()                           # the path's counts
        with allreduce_mode("fp"):
            eng = ServeEngine.from_saved_model(
                str(EXPORT_DIR), device=devs, tp_size=tp,
                registry=MetricsRegistry(), block_size=bs,
                num_blocks=c["num_blocks"], max_batch_size=cfg["max_batch"],
                max_prefill_tokens=cfg["max_prefill"], tile_q=cfg["tile_q"],
                kv_compress_blocks=c["compress_blocks"],
                kv_promote_hits=hits)
        try:
            t0 = time.perf_counter()
            eng.generate(wave1, max_new_tokens=n_new)
            waves = 0
            while head in eng.cache._index:
                check(waves < len(fillers), "fillers never recycled the "
                                            "prefix's fp blocks")
                eng.generate(fillers[waves], max_new_tokens=4)
                waves += 1
            streams = eng.generate(wave2, max_new_tokens=n_new)
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = eng.stats()
            check(all(len(x) == n_new for x in streams),
                  f"{name}: a request did not complete")
            check((st["direct_int8_reads"] > 0) == (hits == 0)
                  and (st["promote_total"] > 0) == (hits == 1),
                  f"{name}: direct reads {st['direct_int8_reads']}, "
                  f"promotions {st['promote_total']}")
            launches = _rank_launches(eng, "ragged_paged_attention_mixed",
                                      layers, cuda)
            scales = [s["qscales"] for s in eng.rank_state()]
            same = all(np.array_equal(a, b) for r in scales[1:]
                       for pa, pb in zip(scales[0], r)
                       for a, b in zip(pa, pb))
            check(same, f"{name}: int8 scales differ between the ranks")
            check(eng.step_graph.compiles == 1, "more than one program")
            eng.cache.assert_quiesced()
            runs[name] = {"steps": eng.steps, "wall_s": wall,
                          "filler_waves": waves, "streams": streams,
                          "rank_launches": launches,
                          "direct_int8_reads": st["direct_int8_reads"],
                          "promote_total": st["promote_total"],
                          "compress_total": st["compress_total"],
                          "scales_equal_across_ranks": same}
        finally:
            codes = _close_tp(eng)
        runs[name]["worker_exit_codes"] = codes
        del eng
        gc.collect()
    same = runs["direct"].pop("streams") == runs["promote"].pop("streams")
    check(same, "tp direct-read streams != promote streams")
    return {**runs["direct"], "promote_run": runs["promote"],
            "streams_equal_promote": same}


# -- serving over HTTP: replicas, the router, KV transfer ------------------

def _scrape(url: str) -> Dict[str, float]:
    status, body = http_get(url + "/metrics")
    check(status == 200, f"{url}/metrics answered {status}")
    return parse_prometheus_values(body)


def _wait_ready(url: str, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if http_get(url + "/readyz")[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.05)
    raise SmokeFailure(f"{url}/readyz never answered 200")


def _wait_idle(frontends, timeout_s: float = 120.0) -> None:
    """Until every replica's engine has no work and no open stream."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(not fe.engine.scheduler.has_work() and not fe._active
               and fe._open_streams == 0 for fe in frontends):
            return
        time.sleep(0.02)
    raise SmokeFailure("the replicas did not drain their work")


def _client_stream(url: str, payload: dict, out: dict, key,
                   stop_after: Optional[int] = None) -> None:
    """One SSE completion from a client thread: tokens, the seconds to
    the first token frame and to [DONE], whether [DONE] arrived; with
    `stop_after`, hang up after that many tokens."""
    t0 = time.perf_counter()
    rec = {"tokens": [], "ttft_s": None, "done": False, "status": None}
    try:
        s = stream_completion(url, payload, timeout=300.0)
        rec["status"] = s.status
        if s.status == 200:
            for ev in s.events():
                if "token" in ev:
                    if rec["ttft_s"] is None:
                        rec["ttft_s"] = time.perf_counter() - t0
                    rec["tokens"].append(ev["token"])
                    if stop_after and len(rec["tokens"]) >= stop_after:
                        s.close()
                        break
            rec["done"] = s.done
        else:
            s.close()
    except Exception as e:            # recorded; the phase checks it
        rec["error"] = repr(e)
    rec["total_s"] = time.perf_counter() - t0
    out[key] = rec


def _spawn_replica(args: List[str]) -> Tuple[subprocess.Popen, str]:
    """`python -m paddle_tpu_torch.serve.replica <args>` from this
    checkout: returns the process and its url, read from the
    `serve_listening` line; a thread drains the rest of its stdout."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serve.replica", *args],
        cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    port = None
    for line in proc.stdout:
        if '"serve_listening"' in line:
            port = json.loads(line)["port"]
            break
    if port is None:
        err = proc.stderr.read()[-2000:]
        proc.kill()
        proc.wait(timeout=30)
        raise SmokeFailure(f"the replica process never listened: {err}")
    for stream in (proc.stdout, proc.stderr):
        threading.Thread(target=stream.read, daemon=True).start()
    return proc, f"http://127.0.0.1:{port}"


def phase_serve_http(cfg: dict, tree: dict, device: torch.device,
                     card: dict) -> dict:
    """The serve layer at full width, as a user runs it: an export of the
    seeded weights served by two replicas built through the replica
    CLI's `build_frontend` (a `--phase prefill` one with a host tier, a
    `--phase decode` one), one after the other, behind an in-process
    `Router` with the prefix directory and KV-transfer hints. The
    replicas build the model from the export in float32, as the JAX
    replica does. Checks:
    - /readyz, and `ptpu_engine_compiles` 1 on each replica's scrape
      before and after the traffic;
    - greedy completions over SSE through the router from concurrent
      client threads (half share a prefix and go to the prefill
      replica, half are short and go to the decode replica) equal a
      direct engine's streams token for token;
    - a client that hangs up after a few tokens is cancelled, and both
      pools quiesce after the drain;
    - a decode-heavy request on the shared prefix goes to the decode
      replica, which pulls the prefix's blocks from the prefill
      replica's /kvblocks (blocks > 0, no fallback) and streams what the
      direct engine streams warm;
    - kernel 1 launched once a layer a step of the two engines together;
    - a replica process (`python -m paddle_tpu_torch.serve.replica
      --model-dir ...`) streams a completion and exits 75 on SIGTERM.
    Client times are on the host clock."""
    cuda = device.type == "cuda"
    sc = cfg["serve_http"]
    t_phase = time.perf_counter()
    export = write_export(cfg, tree)
    vocab, bs, layers = cfg["vocab"], cfg["block_size"], \
        cfg["lm"]["num_layers"]
    common = ["--model-dir", export, "--port", "0",
              "--block-size", str(bs), "--num-blocks", str(cfg["num_blocks"]),
              "--max-batch-size", str(cfg["max_batch"]),
              "--max-prefill-tokens", str(cfg["max_prefill"]),
              "--tile-q", str(cfg["tile_q"]), "--drain-deadline-s", "30",
              "--max-queue-depth", "256",
              # admission must not shed this traffic: the SLO gates are
              # the replica's own business, not this check's
              "--slo-ttft-ms", "1e9", "--slo-tpot-ms", "1e9",
              "--slo-queue-wait-ms", "1e9"]
    if not cuda:
        common += ["--device", "cpu"]
    tier = ["--host-tier-bytes", str(sc["tier_bytes"])]
    t0 = time.perf_counter()
    frontends = {}
    # one after the other: two engines must not capture at once
    for phase in ("prefill", "decode"):
        a = replica_cli.build_parser().parse_args(
            common + tier + ["--phase", phase])
        frontends[phase] = replica_cli.build_frontend(a).start()
    boot_s = time.perf_counter() - t0
    fes = list(frontends.values())
    router = Router([fe.url for fe in fes], enable_directory=True,
                    kv_transfer=True, enable_hedge=False,
                    scrape_interval_s=30.0).start()
    proc = None
    try:
        for fe in fes:
            _wait_ready(fe.url)
            check(fe.engine.device.type == device.type,
                  f"replica serves on {fe.engine.device}")
        compiles_before = {p: _scrape(fe.url)["ptpu_engine_compiles"]
                           for p, fe in frontends.items()}
        check(all(v == 1.0 for v in compiles_before.values()),
              f"compile gauges before the traffic: {compiles_before}")
        router.scrape_now(wait_s=10.0)
        phases = {r.url: r.phase for r in router.replicas}
        check(sorted(phases.values()) == ["decode", "prefill"],
              f"the router read phases {phases}")

        rng = np.random.default_rng(SEED + 60)
        new = sc["new"]
        prefix = rng.integers(0, vocab, sc["prefix"]).tolist()
        lo, hi = sc["suffix"]
        shared = [prefix + rng.integers(0, vocab, int(n)).tolist()
                  for n in np.linspace(lo, hi, sc["requests"] // 2)]
        short = [rng.integers(0, vocab, int(n)).tolist()
                 for n in np.linspace(*sc["short"], sc["requests"] // 2)]
        prompts = shared + short
        _reset_launches()                          # the path's counts
        results: Dict = {}
        threads = [threading.Thread(
            target=_client_stream,
            args=(router.url, {"prompt": p, "max_new_tokens": new},
                  results, i)) for i, p in enumerate(prompts)]
        gone_prompt = rng.integers(0, vocab, sc["short"][0]).tolist()
        threads.append(threading.Thread(
            target=_client_stream,
            args=(router.url, {"prompt": gone_prompt,
                               "max_new_tokens": sc["gone_new"]},
                  results, "gone"), kwargs={"stop_after": 4}))
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wave_s = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a client hung")
        bad = {k: r for k, r in results.items() if k != "gone"
               and not (r["status"] == 200 and r["done"]
                        and len(r["tokens"]) == new)}
        check(not bad, f"streams that failed or were cut: {bad}")
        gone = results["gone"]
        check(gone["status"] == 200 and len(gone["tokens"]) == 4
              and not gone["done"], f"the disconnecting client: {gone}")
        _wait_idle(fes)
        cancelled = sum(fe.engine.obs.get("ptpu_serve_requests_total")
                        .labels(reason="cancelled").value for fe in fes)
        check(cancelled == 1, f"{cancelled} requests cancelled (want 1)")
        for fe in fes:
            fe.engine.cache.assert_quiesced()
        served = {p: fe.engine.obs.get("ptpu_serve_requests_total")
                  .labels(reason="length").value
                  for p, fe in frontends.items()}
        check(all(v > 0 for v in served.values()),
              f"a replica served nothing: {served}")

        # the KV transfer: a decode-heavy request on the shared prefix
        time.sleep(0.4)                # a directory refresh on each
        router.scrape_now(wait_s=10.0)
        xfer_prompt = prefix + rng.integers(0, vocab, bs).tolist()
        check(len(xfer_prompt) < 2 * sc["xfer_new"],
              "the transfer request must be decode-heavy")
        xfer: Dict = {}
        _client_stream(router.url, {"prompt": xfer_prompt,
                                    "max_new_tokens": sc["xfer_new"]},
                       xfer, 0)
        xfer = xfer[0]
        check(xfer["status"] == 200 and xfer["done"]
              and len(xfer["tokens"]) == sc["xfer_new"],
              f"the transfer request: {xfer}")
        dec = frontends["decode"].engine.obs
        kvx = {name: dec.get(f"ptpu_kvxfer_{name}_total").value
               for name in ("blocks", "bytes", "pulls", "fallbacks")}
        check(kvx["blocks"] >= sc["prefix"] // bs and kvx["fallbacks"] == 0,
              f"the decode replica's pull: {kvx}")
        hints = router.obs.get("ptpu_router_kvxfer_hints_total").value
        check(hints >= 1, "the router attached no transfer hint")

        # the router's added latency: the same 1-token request straight
        # to the replica the router routes it to, and through the router,
        # alternated
        probe = {"prompt": short[0][:8], "max_new_tokens": 1}
        target = router._plan(probe["prompt"],
                              probe["max_new_tokens"])[0][0].url
        lat = {"direct": [], "router": []}
        for i in range(2 * sc["latency_pairs"]):
            which = ("direct", "router")[i % 2]
            url = target if which == "direct" else router.url
            rec: Dict = {}
            _client_stream(url, probe, rec, 0)
            check(rec[0]["done"], f"latency probe {which}: {rec[0]}")
            lat[which].append(rec[0]["total_s"] * 1e3)
        _wait_idle(fes)
        steps = {p: fe.engine.steps for p, fe in frontends.items()}
        launches = _expect_launches("ragged_paged_attention",
                                    sum(steps.values()), layers, cuda)
        compiles_after = {p: _scrape(fe.url)["ptpu_engine_compiles"]
                          for p, fe in frontends.items()}
        check(all(v == 1.0 for v in compiles_after.values()),
              f"compile gauges after the traffic: {compiles_after}")
        for fe in fes:
            check_one_program(fe.engine, cuda)
            fe.engine.cache.assert_quiesced()
        replica_ttft = {p: fe.engine.obs.get("ptpu_serve_ttft_ms")
                        .quantile(0.5) for p, fe in frontends.items()}
        # what the engine thread spends on each /kvprefixes + /debug
        # refresh (every --dir-interval-s), at this pool's contents;
        # the loops are idle, so reading from here is safe
        snapshot = {}
        for p, fe in frontends.items():
            t0 = time.perf_counter()
            rows = fe.engine.kv_prefix_directory()
            fe.engine.debug_state()
            snapshot[p] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "rows": len(rows)}

        # the direct engine: the same options on the card, outside the
        # counted window
        direct = ServeEngine.from_saved_model(
            export, device=device, registry=MetricsRegistry(),
            block_size=bs, num_blocks=cfg["num_blocks"],
            max_batch_size=cfg["max_batch"],
            max_prefill_tokens=cfg["max_prefill"], tile_q=cfg["tile_q"])
        want = direct.generate(prompts, max_new_tokens=new)
        same = [results[i]["tokens"] == w for i, w in enumerate(want)]
        check(all(same), f"HTTP streams != the direct engine's: {same}")
        warm = direct.generate([xfer_prompt],
                               max_new_tokens=sc["xfer_new"])[0]
        check(xfer["tokens"] == warm,
              "the pulled stream != the direct engine's warm stream")
        del direct

        # a replica process on the card
        t0 = time.perf_counter()
        proc, url = _spawn_replica(common)
        _wait_ready(url)
        sub_boot_s = time.perf_counter() - t0
        rec = {}
        _client_stream(url, {"prompt": prompts[0],
                             "max_new_tokens": new}, rec, 0)
        check(rec[0]["done"] and rec[0]["tokens"] == want[0],
              f"the replica process's stream: {rec[0]}")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        check(code == PREEMPT_EXIT_CODE,
              f"the replica process exited {code} on SIGTERM (want 75)")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        router.stop()
        for fe in fes:
            fe.stop()

    ttft = [results[i]["ttft_s"] * 1e3 for i in range(len(prompts))]
    tokens = sum(len(results[i]["tokens"]) for i in range(len(prompts)))
    out = {"requests": len(prompts), "new_tokens": new,
           "phase_s": time.perf_counter() - t_phase,
           "prefix": sc["prefix"], "suffix": list(sc["suffix"]),
           "short": list(sc["short"]), "dtype": "float32",
           "boot_s": boot_s, "wave_s": wave_s,
           "client_ttft_p50_ms": float(np.percentile(ttft, 50)),
           "client_ttft_p99_ms": float(np.percentile(ttft, 99)),
           "tokens_per_s": tokens / wave_s,
           "replica_ttft_p50_ms": replica_ttft,
           "router_added_ms": float(np.median(lat["router"])
                                    - np.median(lat["direct"])),
           "direct_1tok_ms_p50": float(np.median(lat["direct"])),
           "dir_snapshot": snapshot,
           "latency_probe_replica": next(
               p for p, fe in frontends.items() if fe.url == target),
           "router_1tok_ms_p50": float(np.median(lat["router"])),
           "served": served, "steps": steps, "layers": layers,
           "kernel_launches": launches, "cancelled": cancelled,
           "kvxfer": kvx, "kvxfer_hints": hints,
           "compiles_before": compiles_before,
           "compiles_after": compiles_after,
           "streams_equal_direct": True, "process_exit": code,
           "process_boot_s": sub_boot_s,
           "device": card["kind"], "nvidia_smi": card["smi"]}
    emit({"phase": "serve_http", **out})
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


def _flash_mode(mode: str, b: int, t: int, device: torch.device,
                lengths: Tuple[int, int] = (1, 1)):
    """(kwargs, q_seg, kv_seg, seed) of a check: plain causal, causal over
    packed documents, causal with dropout 0.1, or `padding`: non-causal
    over the segment ids an encoder makes of lengths drawn in `lengths`
    (real 1, pad 0), as BertEncoder and Transformer.encode give them."""
    kw = dict(causal=mode != "padding")
    segs = seed = None
    if mode == "segments":
        docs = [(t // 3, t // 4, t // 5), (t // 2,), (t // 7, t // 2),
                (t // 5,) * 4]
        segs = torch.from_numpy(np.stack(
            [packed_segment_ids(docs[i % len(docs)], t)
             for i in range(b)])).to(device)
    if mode == "padding":
        lo, hi = lengths
        n = np.random.default_rng(SEED + t).integers(lo, hi + 1, b)
        segs = sequence_mask(torch.from_numpy(n).to(device),
                             t).to(torch.int32)
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


def _flash_check(worst: dict, shape, dtype: torch.dtype, mode: str,
                 device: torch.device, seed: int, **info) -> None:
    """Kernels 4, 5 and 6 each against its plain version on one case of
    `shape` (B, T, H, Hkv, D) in `mode` (`_flash_mode`); folds each
    kernel's error into `worst`."""
    b, t, h, hkv, d = shape
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    f32 = dtype == torch.float32
    otol = (1e-5, 1e-5) if f32 else (2e-2, 2e-2)
    gtol = (1e-4, 1e-4) if f32 else (2e-2, 2e-2)
    info = dict(info, heads=h, kv_heads=hkv, mode=mode, b=b, t=t, d=d,
                dtype=str(dtype).replace("torch.", ""))
    q, k, v, do = _flash_inputs(b, t, h, hkv, d, dtype, device, seed)
    kw, q_seg, kv_seg, drop_seed = _flash_mode(mode, b, t, device,
                                               info.get("lengths", (1, 1)))
    kw["scale"] = d ** -0.5
    plain = [x.float() for x in (q, k, v, do)]
    o, lse = flash.flash_fwd(q, k, v, q_seg, kv_seg, drop_seed, **kw)
    o_ref, lse_ref = flash.flash_fwd_reference(
        *plain[:3], q_seg, kv_seg, drop_seed, **kw)
    sync()
    worst["flash_fwd"] = max(
        worst["flash_fwd"],
        _flash_close("flash_fwd", o, o_ref, *otol, **info),
        _flash_close("flash_fwd", lse, lse_ref, *otol, output="lse", **info))
    o_in = o_ref.to(dtype)
    args = (q, k, v, o_in, lse_ref, do, q_seg, kv_seg, drop_seed)
    ref = (*plain[:3], o_in.float(), lse_ref, plain[3], q_seg, kv_seg,
           drop_seed)
    dq = flash.flash_dq(*args, **kw)
    dk, dv = flash.flash_dkv(*args, **kw)
    sync()
    worst["flash_dq"] = max(worst["flash_dq"], _flash_close(
        "flash_dq", dq, flash.flash_dq_reference(*ref, **kw), *gtol, **info))
    dk_ref, dv_ref = flash.flash_dkv_reference(*ref, **kw)
    worst["flash_dkv"] = max(
        worst["flash_dkv"],
        _flash_close("flash_dkv", dk, dk_ref, *gtol, output="dk", **info),
        _flash_close("flash_dkv", dv, dv_ref, *gtol, output="dv", **info))


def phase_flash_vs_plain(cfg: dict, device: torch.device) -> dict:
    """Kernels 4, 5 and 6 each against its plain version on the same
    inputs at the train phase's attention shape (cfg["flash_check"]: B 4,
    T 2048, H 8, D 64 on the card), MHA and GQA 8:2 (k/v repeated as `mha` repeats them), causal,
    causal over packed documents, and causal with dropout 0.1; then at
    the encoder models' shapes and modes: `bert`'s (B 32, T 128, H 12)
    and the seq2seq encoder's (B 16, T 256, H 8), non-causal with the
    padding of lengths in each phase's range as segment ids, and the
    seq2seq decoder's causal self-attention. f32 at 1e-5 (o, lse) and
    1e-4 (dq, dk, dv), bf16 (the tensor-core kernels) against the plain
    version run in f32 on the same bf16 values at 2e-2 (absolute and
    relative: the kernel rounds p, ds and g to bf16). The backward
    kernels take the plain forward's o and lse, so each kernel is held
    alone. Then GQA end to end: `mha` with 2 kv heads on the card
    against autograd through the plain forward over the repeated heads.
    Returns the worst error per kernel."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    b, t, h, d = cfg["flash_check"]
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    dtypes = (torch.float32, torch.bfloat16)
    for hkv in (h, cfg["gqa_kv_heads"]):
        for dtype in dtypes:
            for mode in ("causal", "segments", "dropout"):
                _flash_check(worst, (b, t, h, hkv, d), dtype, mode, device,
                             SEED + hkv)
    for name, modes in (("bert", ("padding",)),
                        ("seq2seq", ("padding", "causal"))):
        mc = cfg[name]
        mh = mc["num_heads"]
        shape = (mc["batch"], mc["seq"], mh, mh, mc["model_dim"] // mh)
        for dtype in dtypes:
            for mode in modes:
                _flash_check(worst, shape, dtype, mode, device, SEED + 70,
                             model=name, lengths=mc["lengths"])
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


def device_activities(prof) -> list:
    """What ran on the card in a `torch.profiler` trace (kernels,
    memsets, copies), one event each. Only the device's own activities
    count: a CPU op's device time, or a user annotation's device span
    (`Optimizer.step#Adam.step`), is its kernels' again."""
    events = prof.events()
    cpu_names = {e.name for e in events
                 if e.device_type != torch.autograd.DeviceType.CUDA}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in cpu_names
            and not e.name.startswith("Activity Buffer")]


def device_events(prof) -> Dict[str, float]:
    """Device time, us, by name of what ran on the card in a trace."""
    out = {}
    for e in device_activities(prof):
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
    kernel per layer per step and no other launch. Returns the phase's
    numbers, the trainer and its batch (the `profile` phase's)."""
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
    return out, trainer, fixed



# -- the profiler on the train path -------------------------------------------

PROFILE_REGION = "chip_smoke.profile_region"
# the operator a flash kernel runs under in a trace (kernels/flash.py)
FLASH_OPS = {k: f"paddle_tpu_torch::{k}" for k in FLASH_KERNELS}


def _trace_events(trace_dir: Path) -> list:
    files = sorted(trace_dir.glob("*.trace.json.gz"))
    check(len(files) == 1, f"profile: {len(files)} trace files in "
                           f"{trace_dir} (want 1)")
    with gzip.open(files[0], "rt") as f:
        return json.load(f)["traceEvents"]


def phase_profile(cfg: dict, tree: dict, trainer, batch, train_ms: float,
                  device: torch.device, card: dict) -> dict:
    """The port's profiler (paddle_tpu_torch.profiler) on the train
    path: `start_profiler(trace_dir)` around `cfg["profile_steps"]` more
    steps of the `train` phase's trainer on its batch, the middle one
    inside `annotate(PROFILE_REGION)`. Checks: the host table holds
    `Trainer.train_step` once a step and the region once; the flash
    kernels launched once a layer a step and nothing else launched;
    `op_table(trace_dir, by="category")` lists each flash kernel's
    operator at one launch a layer a step; the region shows on the
    device timeline (a `gpu_user_annotation`; on the CPU the host's
    `user_annotation`). Prints the table's top rows and its device ms a
    step beside the `train` phase's median step. Then a short engine
    wave (one prompt, full width) under the profiler, inside an
    annotated region: `merged_chrome_trace` carries the region's host
    span under "engine host" beside the request rows."""
    cuda = device.type == "cuda"
    steps, layers = cfg["profile_steps"], cfg["lm"]["num_layers"]
    trace_dir = EXPORT_DIR.parent / "chip_smoke_profile"
    shutil.rmtree(trace_dir, ignore_errors=True)
    t_phase = time.perf_counter()
    try:
        _reset_launches()
        profiler.start_profiler(str(trace_dir))
        losses = []
        for i in range(steps):
            region = (profiler.annotate(PROFILE_REGION) if i == steps // 2
                      else contextlib.nullcontext())
            with region:
                losses.append(float(trainer.train_step(batch)["loss"]))
        rows = profiler.stop_profiler(print_table=False)
        launches = _expect_launches(FLASH_KERNELS, steps, layers, cuda)
        calls = {r["name"]: r["calls"] for r in rows}
        check(calls == {"Trainer.train_step": steps, PROFILE_REGION: 1},
              f"profile: host table {calls}")
        check(all(np.isfinite(losses)), f"profile: losses {losses}")
        table = profiler.op_table(str(trace_dir), steps=steps,
                                  by="category")
        by_name = {r.name: r for r in table}
        region_cat = "gpu_user_annotation" if cuda else "user_annotation"
        regions = [e for e in _trace_events(trace_dir)
                   if e.get("cat") == region_cat
                   and e.get("name") == PROFILE_REGION]
        check(len(regions) == 1, f"profile: {len(regions)} "
                                 f"{region_cat} events named "
                                 f"{PROFILE_REGION} (want 1)")
        if cuda:
            counts = {op: by_name[op].count if op in by_name else 0
                      for op in FLASH_OPS.values()}
            check(counts == dict.fromkeys(FLASH_OPS.values(), layers),
                  f"profile: flash operators a step {counts} (want "
                  f"{layers} each)")
        else:
            check(table == [], f"profile: device rows on the CPU: {table}")
        device_ms = sum(r.total_ms for r in table)
        top = [{"name": r.name[:80], "ms_per_step": r.total_ms,
                "calls_per_step": r.count, "tflops": r.tflops}
               for r in table[:cfg["profile_top"]]]
        print(profiler.format_table(table[:cfg["profile_top"]]),
              file=sys.stderr, flush=True)
        engine = _profile_engine(cfg, tree, device)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    out = {"steps": steps, "host_table": rows,
           "kernel_launches": launches,
           "flash_ops_per_step": {k: by_name[op].count
                                  for k, op in FLASH_OPS.items()
                                  if op in by_name},
           "top_ops": top, "device_ms_per_step": device_ms if cuda
           else None, "train_step_ms_median": train_ms,
           "device_busy_share": device_ms / train_ms if cuda else None,
           "annotation": region_cat, "engine": engine,
           "seconds": time.perf_counter() - t_phase,
           "device": card["kind"], "nvidia_smi": card["smi"]}
    emit({"phase": "profile", **out})
    return out


def _profile_engine(cfg: dict, tree: dict, device: torch.device) -> dict:
    """One short wave of a full-width bf16 engine under the profiler;
    its merged trace's host spans and request rows."""
    model = _lm(cfg, tree, cfg["dtype"], device)
    engine = ServeEngine(model, **_engine_kw(cfg, device))
    prompt = np.random.default_rng(SEED + 91).integers(
        1, cfg["vocab"], cfg["profile_prompt"]).tolist()
    profiler.start_profiler()
    try:
        with profiler.annotate("engine.generate"):
            engine.generate([prompt], max_new_tokens=cfg["profile_new"])
        trace = merged_chrome_trace(engine.tracer)
    finally:
        profiler.stop_profiler(print_table=False)
    evs = trace["traceEvents"]
    procs = {e["pid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    host = [e["name"] for e in evs if e["ph"] == "X"
            and procs.get(e["pid"]) == "engine host"]
    req = [e["name"] for e in evs if e["ph"] == "X"
           and procs.get(e["pid"]) == "serve requests"]
    check(host == ["engine.generate"], f"profile: engine host spans {host}")
    check({"queued", "prefill", "decode"} <= set(req),
          f"profile: request spans {req}")
    del engine, model
    return {"processes": sorted(procs.values()), "host_spans": host,
            "request_spans": sorted(set(req))}


def phase_selfcheck(cfg: dict, device: torch.device, card: dict) -> dict:
    """`flash_selfcheck()` (kernels/selfcheck.py) at JAX's defaults (B 2,
    H 4, T 1024, D 64, bf16, causal): flash against the plain reference
    forward and backward, segment ids and dropout, asserting the gate
    took the flash path and, on the card, that kernels 4, 5 and 6
    launched as its source expects (`EXPECTED_LAUNCHES`), and nothing
    else. On the CPU rehearsal the gate is forced open (as the tests
    force it) at a small float32 shape."""
    cuda = device.type == "cuda"
    kw = dict(cfg["selfcheck"])
    gate = contextlib.nullcontext()
    if not cuda:
        gate = _forced_flash_gate()
    _reset_launches()
    t0 = time.perf_counter()
    with gate:
        res = flash_selfcheck(device=device, **kw)
    seconds = time.perf_counter() - t0
    launches = _launches()
    want = dict.fromkeys(launches, 0)
    if cuda:
        want.update(EXPECTED_LAUNCHES)
    check(launches == want, f"selfcheck launches {launches} != {want}")
    out = {**res, "shape": {k: (str(v).replace("torch.", "")
                                if k == "dtype" else v)
                            for k, v in kw.items()},
           "expected_launches": EXPECTED_LAUNCHES, "kernel_launches": launches,
           "seconds": seconds, "device": card["kind"],
           "nvidia_smi": card["smi"]}
    emit({"phase": "selfcheck", **out})
    return out


@contextlib.contextmanager
def _forced_flash_gate():
    """attention.would_use_flash open for CPU tensors (the rehearsal)."""
    saved = attention.would_use_flash
    attention.would_use_flash = lambda *a, **k: True
    try:
        yield
    finally:
        attention.would_use_flash = saved


# -- the C-ABI serving shim on the export phase's BERT ------------------------

def _ramp_feed(signature: dict) -> List[np.ndarray]:
    """demo.cc's deterministic inputs for a signature: floats k % 100 /
    100, integers k % 7 (as int32)."""
    feed = []
    for item in signature["inputs"]:
        n = int(np.prod(item["shape"]))
        k = np.arange(n)
        if item["dtype"] in ("int32", "int64"):
            feed.append((k % 7).astype(np.int32).reshape(item["shape"]))
        else:
            feed.append((k % 100 / 100.0).astype(np.float32)
                        .reshape(item["shape"]))
    return feed


def phase_cabi(cfg: dict, model_dir: Path, feed: Dict[str, np.ndarray],
               layers: int, device: torch.device, card: dict) -> dict:
    """serving/'s C ABI on the `export` phase's BERT-base export
    (`model_dir`): `CPredictor` (no device argument: the card) against
    `InferencePredictor` on the same feed within 1e-5 of the largest
    output, one call launching kernel 4 once a layer and nothing else;
    the C++ demo's output sum against the Python predictor's on the
    demo's ramp input; the C++ train demo on the card (loss falls, its
    checkpoint loads); 4 clones serving at once, each answer equal to
    the serial one, and their calls a second against the serial calls a
    second (JAX's bar: at least 0.5x). Prints a C-ABI call's ms beside
    the Python predictor's."""
    cuda = device.type == "cuda"
    cc = cfg["cabi"]
    dev = None if cuda else "cpu"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    build = {"library": serving.build_library(),
             "demo": serving.build_demo(),
             "train_demo": serving.build_train_demo()}
    build_s = time.perf_counter() - t0
    pred = InferencePredictor(str(model_dir), device=device)
    inputs = [feed[n] for n in pred.signature["input_names"]]
    want = pred.run(inputs)[0]
    base = serving.CPredictor(str(model_dir), device=dev)
    try:
        base.run(inputs)                            # warm-up, uncounted
        _reset_launches()
        got = base.run(inputs)[0]
        launches = _launches()
        want_launches = dict.fromkeys(launches, 0)
        if cuda:
            want_launches["flash_fwd"] = layers
        check(launches == want_launches,
              f"cabi: one call's launches {launches} != {want_launches}")
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        check(got.shape == want.shape and err <= 1e-5 * scale,
              f"cabi: C ABI vs InferencePredictor {err} > 1e-5 x {scale}")
        call_ms = _host_call_ms(lambda: base.run(inputs), cc["calls"])
        py_ms = _host_call_ms(lambda: pred.run(inputs), cc["calls"])
        clones = _clone_throughput(base, inputs, got, cc, cuda)
    finally:
        base.close()
    # the same 4-thread ratio on the Python predictor, with its launch
    # lock and without it (what the lock is for)
    threads = {mode: _thread_ratio(pred, inputs, cc, locked)
               for mode, locked in (("locked", True), ("unlocked", False))}
    ramp = _ramp_feed(pred.signature)
    # summed in float64, as the demo sums (float32 pairwise sums of ~1e6
    # outputs near 0 differ from it by ~1e-4)
    py_sum = float(pred.run(ramp)[0].astype(np.float64).sum())
    del pred
    demo = serving.run_demo(str(model_dir), dev, timeout=cc["timeout_s"])
    check(demo.returncode == 0, f"cabi: demo rc {demo.returncode}: "
                                f"{demo.stdout[-800:]} {demo.stderr[-2000:]}")
    line = [ln for ln in demo.stdout.splitlines()
            if ln.startswith("output 0")]
    check(len(line) == 1, f"cabi: demo printed {demo.stdout[-800:]}")
    demo_sum = float(line[0].split("sum=")[1])
    check(abs(demo_sum - py_sum) <= 1e-4 * max(1.0, abs(py_sum)),
          f"cabi: demo sum {demo_sum} != Python predictor's {py_sum}")
    ckpt = model_dir.parent / "train_demo_ckpt"
    t0 = time.perf_counter()
    td = serving.run_train_demo(str(ckpt), dev, timeout=cc["timeout_s"])
    train_demo_s = time.perf_counter() - t0
    check(td.returncode == 0 and "TRAIN DEMO OK" in td.stdout,
          f"cabi: train demo rc {td.returncode}: {td.stdout[-800:]} "
          f"{td.stderr[-2000:]}")
    tree = load_checkpoint(str(ckpt))
    check({"params", "opt"} <= set(tree), f"cabi: checkpoint {set(tree)}")
    out = {"model": "BERT-base forward (export phase)", "layers": layers,
           "feed_shapes": {n: list(x.shape) for n, x in feed.items()},
           "max_abs_err": err, "max_abs_output": scale,
           "kernel_launches": launches, "cabi_call_ms": call_ms,
           "python_call_ms": py_ms, "clones": clones,
           "python_threads": threads,
           "demo_line": line[0], "demo_sum": demo_sum,
           "python_sum": py_sum,
           "train_demo_losses": [ln for ln in td.stdout.splitlines()
                                 if ln.startswith(("step", "first"))],
           "train_demo_s": train_demo_s, "build_s": build_s,
           "built": {k: os.path.basename(v) for k, v in build.items()},
           "seconds": time.perf_counter() - t_phase,
           "device": card["kind"], "nvidia_smi": card["smi"]}
    emit({"phase": "cabi", **out})
    return out


def _host_call_ms(fn, calls: int) -> float:
    """Median host ms of `calls` calls of `fn` (each returns host numpy,
    so each call waits for its work)."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _thread_ratio(pred, inputs, cc: dict, locked: bool) -> dict:
    """Calls a second of `cc["clones"]` threads sharing the Python
    predictor `pred` over its serial calls a second; `locked=False` runs
    them with its launch lock replaced by a no-op."""
    n, k = cc["clone_calls"], cc["clones"]
    t0 = time.perf_counter()
    for _ in range(n * k):
        pred.run(inputs)
    serial = n * k / (time.perf_counter() - t0)
    saved = pred._lock
    if not locked:
        pred._lock = contextlib.nullcontext()
    try:
        threads = [threading.Thread(
            target=lambda: [pred.run(inputs) for _ in range(n)])
            for _ in range(k)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        conc = n * k / (time.perf_counter() - t0)
    finally:
        pred._lock = saved
    return {"serial_calls_per_s": serial, "thread_calls_per_s": conc,
            "ratio": conc / serial}


def _clone_throughput(base, inputs, want: np.ndarray, cc: dict,
                      cuda: bool) -> dict:
    """Serial calls a second on `base`, then `cc["clones"]` clones on as
    many threads: every clone's answer equals `want`, and on the card the
    ratio of the two rates is at least JAX's bar (0.5)."""
    n, k = cc["clone_calls"], cc["clones"]
    t0 = time.perf_counter()
    for _ in range(n * k):
        base.run(inputs)
    serial = n * k / (time.perf_counter() - t0)
    clones = [base.clone() for _ in range(k)]
    errors: List[str] = []

    def worker(c):
        try:
            for _ in range(n):
                if not np.array_equal(c.run(inputs)[0], want):
                    errors.append("a clone's answer differs")
        except Exception as e:      # a dead worker fails the phase
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(c,)) for c in clones]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=cc["timeout_s"])
    conc = n * k / (time.perf_counter() - t0)
    hung = any(t.is_alive() for t in threads)
    if not hung:
        for c in clones:
            c.close()
    check(not hung, "cabi: a clone thread hung")
    check(not errors, f"cabi: clones: {errors[:3]}")
    ratio = conc / serial
    # the bar is a rate on the card's clock; the CPU rehearsal runs beside
    # other processes and only prints it
    check(ratio >= 0.5 or not cuda,
          f"cabi: {k} clones at {conc:.1f} calls/s, {ratio:.2f}x the "
          f"serial {serial:.1f} (bar 0.5x)")
    return {"clones": k, "calls_each": n, "serial_calls_per_s": serial,
            "clone_calls_per_s": conc, "ratio": ratio, "bar": 0.5}

# -- the file-fed training path (AsyncExecutor.RunFromFile) -----------------

SLOT_CONFIG = "tokens:int64:sparse"
# a program that needs zlib's header and library, as recordio.cc does
ZLIB_PROBE = ('#include <zlib.h>\n'
              'int main() { return zlibVersion()[0] == 0; }\n')


def native_toolchain(root: Path) -> dict:
    """Can g++ build the port's native libraries here: its version,
    zlib's header (`echo '#include <zlib.h>' | g++ -E -`) and a `-lz`
    link, each with g++'s message when it fails."""
    out = {}
    try:
        ver = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60)
        out["gxx"] = ver.stdout.splitlines()[0] if ver.stdout else None
    except OSError as e:
        out["gxx"], out["gxx_error"] = None, str(e)
        return out
    head = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                          input="#include <zlib.h>\n", capture_output=True,
                          text=True, timeout=60)
    out["zlib_header"] = head.returncode == 0
    src = root / "zlib_probe.cc"
    src.write_text(ZLIB_PROBE)
    link = subprocess.run(["g++", str(src), "-lz", "-o",
                           str(root / "zlib_probe")], capture_output=True,
                          text=True, timeout=120)
    out["zlib_link"] = link.returncode == 0
    for name, res in (("zlib_header", head), ("zlib_link", link)):
        if res.returncode != 0:
            out[name + "_error"] = res.stderr[-1000:]
    return out


def slot_rows(rng: np.random.Generator, n: int, seq: int, vocab: int,
              window: int) -> np.ndarray:
    """`n` distinct rows of T + 1 = `seq` + 1 ids of lm_stream's learnable
    stream (next token = token + 3 mod vocab), int64, their first tokens
    drawn without replacement from [0, window): every row covers nearly
    the same tokens, so a few steps over new rows learn them, as the
    train phase's steps over its one batch do."""
    start = rng.choice(min(window, vocab), n, replace=False)[:, None]
    return (start + np.arange(seq + 1)[None, :] * 3) % vocab


def _sorted_rows(rows: np.ndarray) -> np.ndarray:
    return rows[np.lexsort(rows.T[::-1])]


def files_recordio(root: Path, fc: dict, seed: int) -> dict:
    """RecordIO on this host: `fc["records"]` records of 1-2048 random
    bytes written and read back natively (the Python path where the
    library did not build), compressed and not; `count` agrees; a flipped
    payload byte raises the CRC error; `prefetch_reader` over both files
    yields the same records."""
    native = recordio.native_available()
    if not native:
        print(f"recordio native library unavailable: "
              f"{recordio.native_error()}", flush=True)
    rng = np.random.default_rng(seed)
    recs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(1, 2049, fc["records"])]
    out = {"recordio_native": native, "records": len(recs),
           "bytes": sum(map(len, recs))}
    paths = []
    for compress in (False, True):
        path = str(root / f"records_{int(compress)}.rio")
        t0 = time.perf_counter()
        with recordio.Writer(path, compress=compress,
                             force_python=not native) as w:
            for r in recs:
                w.write(r)
        t1 = time.perf_counter()
        got = list(recordio.Scanner(path, force_python=not native))
        t2 = time.perf_counter()
        check(got == recs, f"recordio (compress={compress}): records read "
                           f"back differ")
        check(recordio.count(path) == len(recs),
              f"recordio count {recordio.count(path)} != {len(recs)}")
        key = "zlib" if compress else "raw"
        out[f"{key}_file_bytes"] = os.path.getsize(path)
        out[f"{key}_write_ms"] = (t1 - t0) * 1e3
        out[f"{key}_read_ms"] = (t2 - t1) * 1e3
        paths.append(path)
    got = list(recordio.prefetch_reader(paths, n_threads=2)())
    check(sorted(got) == sorted(recs * 2),
          "recordio prefetch_reader: records differ")
    bad = root / "flipped.rio"
    raw = bytearray(Path(paths[0]).read_bytes())
    raw[30] ^= 0xFF                     # a payload byte of the first chunk
    bad.write_bytes(bytes(raw))
    try:
        list(recordio.Scanner(str(bad), force_python=not native))
        crc = None
    except IOError as e:
        crc = str(e)
    check(crc is not None and "crc" in crc,
          f"recordio: a flipped payload byte read without the CRC error "
          f"({crc})")
    out["flipped_byte_error"] = crc
    return out


def phase_files(cfg: dict, tree: dict, device: torch.device, card: dict,
                train_ms: float) -> dict:
    """Training straight from slot files (`train_from_files`, the JAX
    package's AsyncExecutor.RunFromFile path): `fc["files"]` slot files
    of `fc["rows"]` rows, each row one sparse slot `tokens` of T + 1 ids
    of the learnable stream (next token = token + 3 mod V, `slot_rows`),
    written by `write_slot_file`; the native DataFeed (`native=True`, 2
    threads) parses them, `to_padded` pads them, `device_prefetch` (2 in
    flight) puts them on the card, and a bf16 CausalLM at the train
    phase's width and B trains on them with Adam: inputs [:, :T], labels
    [:, 1:].
    Checks: every batch that reached the card equals rows that were
    written (sorted rows compared); finite losses that fall; one launch
    of each flash kernel per layer per step and no other launch; then
    RecordIO, DLPack and memory_stats on the card. Prints the step times
    beside the train phase's median, the host's parse + pad ms a batch,
    the card's busy share of a step, the peak memory and whether both
    native libraries built."""
    fc = cfg["files"]
    cuda = device.type == "cuda"
    tag = {"device": card["kind"], "nvidia_smi": card["smi"]}
    t_phase = time.perf_counter()
    root = EXPORT_DIR.parent / "chip_smoke_files"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    seq, vocab, batch = cfg["train_seq"], cfg["vocab"], cfg["train_batch"]
    try:
        # both native libraries build with g++ at first use: together
        builders = [threading.Thread(target=lib.get) for lib in
                    (data.datafeed._lazy, recordio.recordio._lazy)]
        t_build = time.perf_counter()
        for th in builders:
            th.start()
        tools = native_toolchain(root)
        for th in builders:
            th.join()
        tools["native_build_s"] = time.perf_counter() - t_build
        tools["native_errors"] = {
            "datafeed": data.datafeed._lazy.error,
            "recordio": recordio.recordio._lazy.error}
        emit({"phase": "files", "part": "toolchain", **tools})
        rows = slot_rows(np.random.default_rng(SEED + 21),
                         fc["files"] * fc["rows"], seq, vocab, fc["window"])
        files = []
        for i, part in enumerate(np.split(rows, fc["files"])):
            files.append(str(root / f"part-{i}.txt"))
            write_slot_file(files[-1], [[r.tolist()] for r in part],
                            SLOT_CONFIG)
        written = _sorted_rows(rows)

        def batch_fn(b):
            padded, mask = b["tokens"]
            check(bool(mask.all()), "files: a row shorter than T + 1")
            return padded[:, :seq], padded[:, 1:]

        # the host's parse + pad a batch, native and Python, off the step
        parse_ms = {}
        for native in (True, False):
            t0, n = time.perf_counter(), 0
            for b in data.MultiSlotDataFeed(files, SLOT_CONFIG,
                                            batch_size=batch, nthreads=2,
                                            native=native):
                batch_fn({"tokens": data.to_padded(*b["tokens"], seq + 1)})
                n += 1
            parse_ms["native" if native else "python"] = \
                (time.perf_counter() - t0) * 1e3 / n
        libs = {"datafeed": str(data.datafeed._lazy.path),
                "recordio": str(recordio.recordio._lazy.path)
                if recordio.native_available() else None}

        model = _lm(cfg, tree, cfg["dtype"], device)
        trainer = Trainer(model, Adam(model.parameters(), cfg["train_lr"]),
                          lm_loss, seed=SEED)
        trainer.train_step(_lm_batches(cfg, 1, batch, device,
                                       SEED + 22)[0])  # warm-up, uncounted
        seen: List[Tuple[torch.Tensor, torch.Tensor]] = []

        def recording_loss(module, b, generator, training):
            seen.append(b)
            return lm_loss(module, b, generator, training)
        trainer.loss_fn = recording_loss
        losses, stamps = [], []

        def callback(step, fetches):
            losses.append(float(fetches["loss"]))   # syncs the step
            stamps.append(time.perf_counter())
        start_bytes = _phase_mem(cuda)
        _reset_launches()                            # the path's counts
        t0 = time.perf_counter()
        train_from_files(trainer, files, SLOT_CONFIG, batch_fn,
                         batch_size=batch, nthreads=2, prefetch=2,
                         max_sparse_len=seq + 1, drop_last=True,
                         callback=callback, native=True)
        wall = time.perf_counter() - t0
        steps = len(losses)
        layers = cfg["lm"]["num_layers"]
        launches = _expect_launches(FLASH_KERNELS, steps, layers, cuda)
        peak = torch.cuda.max_memory_allocated() if cuda else None
        check(steps == fc["files"] * fc["rows"] // batch,
              f"files: {steps} steps from {fc['files']} x {fc['rows']} "
              f"rows at B {batch}")
        on = next(model.parameters()).device
        check(all(x.device == on and y.device == on for x, y in seen),
              f"files: a batch not on the model's device {on}")
        got = np.concatenate([torch.cat([x, y[:, -1:]], 1).cpu().numpy()
                              for x, y in seen])
        check(all(torch.equal(x[:, 1:], y[:, :-1]) for x, y in seen),
              "files: labels are not the inputs shifted by one")
        check(got.shape == written.shape
              and np.array_equal(_sorted_rows(got), written),
              "files: the batches on the card differ from the written rows")
        check(all(np.isfinite(losses)), f"files: non-finite losses {losses}")
        third = max(1, steps // 3)
        check(np.mean(losses[-third:]) < np.mean(losses[:third]),
              f"files: loss did not fall: {losses}")
        step_ms = list(np.diff([t0] + stamps) * 1e3)
        med = float(np.median(step_ms))
        out = {"files": fc["files"], "rows": fc["rows"], "steps": steps,
               "batch": batch, "seq": seq,
               "dtype": str(cfg["dtype"]).replace("torch.", ""),
               "losses": losses, "step_ms": step_ms,
               "step_ms_median": med, "train_step_ms_median": train_ms,
               "step_vs_train": med / train_ms, "wall_s": wall,
               "tokens_per_s": batch * seq / med * 1e3,
               "parse_pad_ms_per_batch": parse_ms,
               "parse_vs_step": parse_ms["native"] / med,
               "peak_bytes": peak, "allocated_at_start_bytes": start_bytes,
               "kernel_launches": launches, "layers": layers,
               "datafeed_native": True, "native_libraries": libs, **tag}
        emit({"phase": "files", "part": "train", **out})
        if cuda:
            prof = step_profile(trainer, seen[-1], med)
            out["device_busy_ms"] = prof["device_busy_ms"]
            out["idle_share"] = prof["idle_share"]
            emit({"phase": "files", "part": "profile", **prof, **tag})

        rio = files_recordio(root, fc, SEED + 23)
        out.update(rio)
        t = torch.arange(1 << 20, dtype=torch.float32, device=device)
        u = from_dlpack(to_dlpack(t))
        v = from_dlpack(t)
        check(u.data_ptr() == t.data_ptr() == v.data_ptr()
              and u.device == t.device == v.device and torch.equal(u, t),
              "files: DLPack round trip copied or moved the tensor")
        if cuda:
            dev = f"cuda:{torch.cuda.current_device()}"
            stats = memory_stats(dev)
            allocated = torch.cuda.memory_allocated()
            check(stats["bytes_in_use"] == allocated,
                  f"memory_stats({dev!r}) {stats['bytes_in_use']} != "
                  f"memory_allocated() {allocated}")
        else:
            stats = memory_stats("cpu")
        out["memory_stats"] = stats
        emit({"phase": "files", "part": "runtime", **rio,
              "dlpack_same_ptr": True, "memory_stats": stats,
              "datafeed_native": True, **tag})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "files", "part": "seconds", "seconds": out["seconds"]})
    return out


LM_GROUPS = list(TENSOR_CORE_KERNELS) + ["gemm", "other"]


def lm_kernel_group(name: str, in_optimizer: bool) -> str:
    """A kernel's group in a transformer step: a flash kernel of
    TENSOR_CORE_KERNELS, a GEMM, or other."""
    group = next((g for g, key in TENSOR_CORE_KERNELS.items()
                  if key in name), None)
    if group is not None:
        return group
    return ("gemm" if any(k in name.lower() for k in GEMM_NAME_KEYS)
            else "other")


def step_profile(trainer, batch, step_ms: float,
                 kernel_group: Callable[[str, bool], str] = lm_kernel_group,
                 groups: Sequence[str] = LM_GROUPS) -> dict:
    """One more training step under `torch.profiler` (after the counted
    steps; its launches are not counted): the card's busy time in the
    step by `kernel_group(name, in_optimizer)` (in_optimizer: the kernel
    starts inside the device span of `Optimizer.step`), each group's
    kernel count and first names, the host's kernel launches
    (`trace_counts`), the copy kernels, and the idle share against the
    median unprofiled step `step_ms`."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(trainer.train_step(batch)["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and getattr(e, "is_user_annotation", False)
             and e.name.startswith("Optimizer.step")]
    by_group = dict.fromkeys(groups, 0.0)
    count = dict.fromkeys(groups, 0)
    names: Dict[str, set] = {g: set() for g in groups}
    by_name: Dict[str, float] = {}
    copies = 0
    for e in device_activities(prof):
        start, us = e.time_range.start, e.time_range.elapsed_us()
        group = kernel_group(e.name, any(a <= start < b for a, b in spans))
        by_group[group] += us / 1e3
        count[group] += 1
        names[group].add(e.name[:100])
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        copies += ("copy" in e.name.lower() or e.name.startswith("Memcpy"))
    busy = sum(by_group.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_busy_ms": busy, "step_ms_median": step_ms,
            "idle_share": 1.0 - busy / step_ms,
            "profiled_step_wall_ms": wall, "busy_ms_by_group": by_group,
            "kernels_by_group": count,
            "first_names_by_group": {g: sorted(n)[:4]
                                     for g, n in names.items()},
            "optimizer_spans": len(spans), "copy_kernels": copies,
            "host_launches": trace_counts(prof)["host_launches"],
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


def _step_vs_plain(build, loss_fn, batch, layers: int, seed: int,
                   lr: float, cuda: bool) -> Tuple[float, dict, dict, dict]:
    """One Trainer step three ways on the same weights and batch: through
    the flash kernels, through their plain versions (`plain_flash`) and
    through `mha`'s dense path (`dense_attention`). `build()` returns
    (a model made anew, its FFNs), whose ReLU gates are recorded.
    Returns (the plain loss, the plain gradients, the tensors
    zero up to rounding, {kernels, dense}: each run's loss and gradient
    gaps to the plain run, and its ReLU gate flips)."""
    runs = {}
    for name, ctx, launched in (
            ("kernels", contextlib.nullcontext(), 1),
            ("plain", plain_flash(), 0), ("dense", dense_attention(), 0)):
        model, ffns = build()
        trainer = Trainer(model, Adam(model.parameters(), lr), loss_fn,
                          seed=seed)
        gates = []
        hooks = [ffn.fc1.register_forward_hook(
            lambda mod, inp, out: gates.append(out.detach() > 0))
            for ffn in ffns]
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
    return lp, gp, noise, out


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

    def build():
        model = _lm(cfg, tree, torch.float32, device)
        return model, [blk.ffn for blk in model.blocks]
    lp, gp, noise, out = _step_vs_plain(build, lm_loss, batch, layers, SEED,
                                        cfg["train_lr"], cuda)
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


# -- the resilient training loop -----------------------------------------

def weighted_lm_loss(module, batch, generator, training):
    """`lm_loss` over (inputs, targets, weights): the weighted mean of the
    per-token fused cross-entropy. The float32 weights (all ones) are
    the batch's floating leaf, so an injected NaN reaches the loss of a
    batch of integer tokens."""
    inp, tgt, w = batch
    hid = module(inp, return_hidden=True, generator=generator)
    wt, bias = module.head_weights()
    per = linear_cross_entropy(hid, wt.to(hid.dtype), tgt,
                               None if bias is None else bias.to(hid.dtype))
    return (per * w).sum() / w.sum(), {}


@contextlib.contextmanager
def chaos_env(**env):
    """Arm PTPU_CHAOS_* (and friends) for one run; restore after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    chaos.reset()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        chaos.reset()


class _Preempted(Exception):
    """Raised by the `resilient` phase's supervisor in place of exiting."""


class _StallFirstStep:
    """A trainer whose first `train_step` sleeps `delay_s` first (a
    wedged step for the watchdog) and then calls `after_stall` (which
    stops the watchdog, so that only the stalled step is watched: a later
    step slowed by a loaded host is no hang); everything else is the
    inner one's."""

    def __init__(self, inner, delay_s: float, after_stall):
        self._inner = inner
        self._delay_s = delay_s
        self._after_stall = after_stall

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def train_step(self, batch, generator=None):
        if not self._delay_s:
            return self._inner.train_step(batch, generator=generator)
        time.sleep(self._delay_s)
        self._delay_s = 0.0
        out = self._inner.train_step(batch, generator=generator)
        self._after_stall()
        return out


def phase_resilient(cfg: dict, tree: dict, device: torch.device,
                    card: dict) -> dict:
    """The resilient training loop: `train_resilient` over a guarded
    `MeshTrainer` (bad_step_budget 2; the default mesh over the card) on
    the train path's configuration (bf16 CausalLM, Adam, B x T of
    cfg["resilient"], dropout 0), `save_every` 2, checkpoints in a
    temporary directory, with a GoodputLedger, the MFU meter, a
    DeviceMemoryMonitor and the step-phase histograms on a registry of
    each run's own. Runs, in order:
    (a) clean, sync saves; (b) clean, async saves; (c) NaN burst at
    steps 2-3; (d) NaN at step 3 for 3 attempts (blows the budget: one
    rollback); (e) SIGTERM at step 3 under a supervisor whose exit
    raises, then a trainer made anew resumes from `restore_latest`; (f)
    two injected shard-write faults and the last checkpoint corrupted,
    then `restore_latest` falls back; (g) a first step held past a 0.2 s
    watchdog with a FlightRecorder, the watchdog stopped once that step
    returns. Checks: every run's curve and every
    state leaf equal run (a)'s; the event counts; the ledger's counts ==
    the tapped event stream; MFU in (0, 1] (card); the memory gauge's
    peak >= torch.cuda.max_memory_allocated (card); run (a)'s registry
    scraped over HTTP from a MetricsServer shows the training series;
    one bundle naming step 0; each flash kernel launched attempts x
    layers times a run."""
    cuda = device.type == "cuda"
    rcfg = cfg["resilient"]
    steps, batch, every = rcfg["steps"], rcfg["batch"], rcfg["save_every"]
    layers = cfg["lm"]["num_layers"]
    data = _lm_batches(cfg, steps, batch, device, SEED + 50)
    ones = torch.ones(batch, cfg["train_seq"], device=device)

    def batch_for(step):
        return (*data[step], ones)

    def new_trainer(init=True):
        model = (_lm(cfg, tree, cfg["dtype"], device) if init else
                 CausalLM(vocab=cfg["vocab"], max_len=cfg["max_len"],
                          dtype=cfg["dtype"], device=device, **cfg["lm"]))
        return MeshTrainer(
            model, Adam(model.parameters(), cfg["train_lr"]),
            weighted_lm_loss, None if cuda else make_mesh(devices=[device]),
            strategy=DistStrategy(bad_step_budget=rcfg["budget"]), seed=SEED)

    flops = None
    tmp_root = tempfile.mkdtemp(prefix="resilient-")
    runs: Dict[str, dict] = {}
    want: Dict[str, torch.Tensor] = {}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def run(name, trainer, *, async_save=False, start=0, supervisor=None,
            recorder=None, keep=False, losses=None, tapped=None,
            scrape=False):
        """One train_resilient run; returns its record (and leaves the
        checkpoints in place when `keep`). `losses` and `tapped` (the
        resilience events by name) fill the caller's dicts when given,
        so a preempted run's are kept. With `scrape`, the run's registry
        is served by a MetricsServer and scraped over HTTP after it."""
        nonlocal flops
        ckdir = os.path.join(tmp_root, name)
        reg = MetricsRegistry()
        goodput = GoodputLedger(registry=reg)
        tapped = {} if tapped is None else tapped

        def tap(stream, rec):
            if stream == "resilience":
                tapped[rec["evt"]] = tapped.get(rec["evt"], 0) + 1

        if flops is None:
            flops = causal_lm_step_flops(
                batch_size=batch, seq_len=cfg["train_seq"],
                d_model=cfg["lm"]["model_dim"], n_layers=layers,
                n_params=param_count(trainer.module))
        monitor = DeviceMemoryMonitor(
            registry=reg, devices=None if cuda else [device])
        mgr = CheckpointManager(ckdir, max_to_keep=3, async_save=async_save)
        losses = {} if losses is None else losses
        done = []                  # every completed step, redone ones too

        def on_step(step, fetches):
            losses[step] = float(fetches["loss"])
            done.append(step)

        add_event_tap(tap)
        try:
            with (MetricsServer(reg, port=0) if scrape
                  else contextlib.nullcontext()) as srv:
                train_resilient(
                    trainer, batch_for, steps, mgr, start_step=start,
                    save_every=every, supervisor=supervisor,
                    on_step=on_step, registry=reg, goodput=goodput,
                    flops_per_step=flops, flight_recorder=recorder,
                    memory_monitor=monitor)
                body = (urllib.request.urlopen(srv.url, timeout=30).read()
                        .decode() if scrape else "")
        finally:
            remove_event_tap(tap)
        max_alloc = torch.cuda.max_memory_allocated() if cuda else None
        phase_ms = reg.get("ptpu_train_phase_ms")
        mfu = reg.get("ptpu_train_mfu")
        out = {"losses": [losses[s] for s in sorted(losses)],
               "steps_run": done,
               "attempts": len(done) + tapped.get("bad_step_skip", 0),
               "events": tapped, "ledger_events": goodput.event_counts(),
               "goodput": goodput.goodput(),
               "productive_s": goodput.productive_seconds(),
               "lost_s": goodput.lost_seconds(),
               "mfu": None if mfu is None else mfu.value,
               "hbm_peak_bytes": reg.get("ptpu_hbm_peak_bytes").labels(
                   device="d0").value,
               "hbm_in_use_bytes": reg.get("ptpu_hbm_bytes_in_use").labels(
                   device="d0").value,
               "max_memory_allocated": max_alloc}
        if phase_ms is not None:
            # p50 / p99 are the registry's log-bucket estimates; the means
            # (sum / count) are exact
            out["phase_ms"] = {
                ph: {"p50": phase_ms.labels(phase=ph).quantile(0.5),
                     "p99": phase_ms.labels(phase=ph).quantile(0.99),
                     "mean": phase_ms.labels(phase=ph).mean()}
                for ph in ("dispatch", "wait")}
            step_h = reg.get("ptpu_train_step_ms")
            out["step_ms_p50"] = step_h.quantile(0.5)
            out["step_ms_mean"] = step_h.mean()
            out["compiles"] = reg.get("ptpu_train_compiles").value
        check(out["ledger_events"] == {k: float(v) for k, v in
                                       tapped.items()},
              f"{name}: ledger {out['ledger_events']} != stream {tapped}")
        if cuda:
            check(mfu is not None and 0.0 < mfu.value <= 1.0,
                  f"{name}: MFU gauge {out['mfu']}")
            check(out["hbm_peak_bytes"] >= max_alloc,
                  f"{name}: memory gauge peak {out['hbm_peak_bytes']} < "
                  f"max_memory_allocated {max_alloc}")
        if scrape:
            series = ['ptpu_train_phase_ms_bucket{phase="dispatch"',
                      "ptpu_train_steps_total", "ptpu_train_goodput",
                      'ptpu_hbm_peak_bytes{device="d0"}',
                      "ptpu_train_input_wait_ms_bucket"]
            series += ["ptpu_train_mfu"] if cuda else []
            out["scraped"] = {x: x in body for x in series}
            check(all(out["scraped"].values()),
                  f"{name}: /metrics lacks {out['scraped']}")
        if not keep:
            shutil.rmtree(ckdir, ignore_errors=True)
        return out

    def finish(name, trainer, out):
        got = _state_leaves(trainer)
        if not want:
            want.update(got)
        out["unequal_leaves"] = sorted(
            k for k in want if not torch.equal(got[k], want[k]))
        launches = _expect_launches(FLASH_KERNELS, out["attempts"], layers,
                                    cuda)
        out["kernel_launches"] = {k: launches[k] for k in FLASH_KERNELS}
        runs[name] = out
        check(out["losses"] == runs["a"]["losses"],
              f"{name}: losses {out['losses']} != (a)'s")
        check(not out["unequal_leaves"],
              f"{name}: state differs from (a) at "
              f"{out['unequal_leaves'][:5]}")

    try:
        _reset_launches()
        trainer = new_trainer()
        finish("a", trainer, run("a", trainer, scrape=True))
        del trainer
        _reset_launches()
        trainer = new_trainer()
        finish("b", trainer, run("b", trainer, async_save=True))
        del trainer
        with chaos_env(PTPU_CHAOS_NAN_STEP="2:3"):
            _reset_launches()
            trainer = new_trainer()
            finish("c", trainer, run("c", trainer))
        with chaos_env(PTPU_CHAOS_NAN_STEP=3, PTPU_CHAOS_NAN_ATTEMPTS=3):
            _reset_launches()
            trainer = new_trainer()
            finish("d", trainer, run("d", trainer))
        del trainer
        gc.collect()

        # (e): preempted at step 3, resumed by a trainer made anew
        _reset_launches()
        trainer = new_trainer()
        sup_dir = os.path.join(tmp_root, "e")

        def _exit(code):
            raise _Preempted(code)

        pre_losses: Dict[int, float] = {}
        pre_events: Dict[str, int] = {}
        with chaos_env(PTPU_CHAOS_SIGTERM_STEP=3):
            sup = RunSupervisor(CheckpointManager(sup_dir, max_to_keep=3),
                                _exit_fn=_exit)
            try:
                with sup:
                    run("e", trainer, supervisor=sup, keep=True,
                        losses=pre_losses, tapped=pre_events)
                raise SmokeFailure("(e): the run was not preempted")
            except _Preempted as e:
                exit_code = e.args[0]
        pre = {"exit_code": exit_code, "attempts": trainer.step,
               "losses": [pre_losses[s] for s in sorted(pre_losses)],
               "events": pre_events,
               "checkpoints": sorted(os.listdir(sup_dir))}
        check(exit_code == PREEMPT_EXIT_CODE and sorted(pre_losses) ==
              [0, 1, 2] and "ckpt-3" in pre["checkpoints"] and
              pre_events == {"chaos_inject": 1, "preempt": 1},
              f"(e): preemption {pre}")
        del trainer, sup
        gc.collect()
        resumed = new_trainer(init=False)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, rstep = CheckpointManager(sup_dir).restore_latest(
            target=resumed.state())
        resumed.load_state(ts)
        if cuda:
            torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        del ts
        check(rstep == 3 and resumed.step == 3,
              f"(e): restored step {rstep}, trainer step {resumed.step}")
        out = run("e", resumed, start=rstep)
        out.update(preempted=pre, restore_ms=restore_ms,
                   attempts=out["attempts"] + pre["attempts"])
        out["losses"] = pre["losses"] + out["losses"]
        finish("e", resumed, out)
        del resumed
        gc.collect()

        # (f): transient shard-write faults, the final checkpoint torn
        _reset_launches()
        trainer = new_trainer()
        with chaos_env(PTPU_CHAOS_CKPT_IO=2, PTPU_CHAOS_CORRUPT_STEP=steps):
            out = run("f", trainer, keep=True)
        rejects: List[dict] = []

        def reject_tap(stream, rec):
            if stream == "resilience" and rec["evt"] == "ckpt_reject":
                rejects.append(rec)

        add_event_tap(reject_tap)
        try:
            t0 = time.perf_counter()
            ts, fstep = CheckpointManager(
                os.path.join(tmp_root, "f")).restore_latest(
                    target=trainer.state())
            out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            remove_event_tap(reject_tap)
        del ts
        out["fallback"] = {"step": fstep,
                           "rejected": [r["ckpt"] for r in rejects]}
        check(fstep == steps - every and
              [r["ckpt"] for r in rejects] == [f"ckpt-{steps}"],
              f"(f): fell back to {fstep}, rejected {out['fallback']}")
        finish("f", trainer, out)
        shutil.rmtree(os.path.join(tmp_root, "f"), ignore_errors=True)
        del trainer
        gc.collect()

        # (g): a first step held past the watchdog
        _reset_launches()
        trainer = new_trainer()
        reg_g = MetricsRegistry()
        rec = FlightRecorder(streams=("resilience", "obs"),
                             snapshot_fn=lambda: {"metrics":
                                                  reg_g.snapshot()},
                             out_dir=os.path.join(tmp_root, "flightrec"),
                             registry=reg_g)
        with RunSupervisor(CheckpointManager(os.path.join(tmp_root, "g")),
                           watchdog_timeout_s=rcfg["watchdog_s"]) as sup:
            stalled = _StallFirstStep(trainer, rcfg["stall_s"],
                                      sup.stop_watchdog)
            out = run("g", stalled, supervisor=sup, recorder=rec)
        paths = rec.dump_paths()
        bundle = json.load(open(paths[0])) if len(paths) == 1 else {}
        out["flightrec"] = {"bundles": len(paths),
                            "trigger": bundle.get("trigger"),
                            "context": bundle.get("context"),
                            "hung_steps": sup.hung_steps}
        check(len(paths) == 1 and bundle["trigger"] == "watchdog_hang"
              and bundle["context"]["step"] == 0 and sup.hung_steps == [0],
              f"(g): flight recorder {out['flightrec']}")
        finish("g", trainer, out)
        del trainer, stalled
        gc.collect()
    finally:
        shutil.rmtree(tmp_root, ignore_errors=True)

    expect = {"a": {}, "b": {},
              "c": {"chaos_inject": 2, "bad_step_skip": 2},
              "d": {"chaos_inject": 3, "bad_step_skip": 3, "rollback": 1},
              "e": {}, "f": {"chaos_inject": 3, "retry": 2},
              "g": {"hang": 1}}
    got = {k: r["events"] for k, r in runs.items()}
    emit({"phase": "resilient", "steps": steps, "batch": batch,
          "seq": cfg["train_seq"],
          "dtype": str(cfg["dtype"]).replace("torch.", ""),
          "save_every": every, "bad_step_budget": rcfg["budget"],
          "flops_per_step": flops, "runs": runs,
          "device": card["kind"], "nvidia_smi": card["smi"]})
    check(got == expect, f"event counts {got} != {expect}")
    return runs


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


# -- the encoder models: BERT MLM and the seq2seq Transformer --------------

def _phase_mem(cuda: bool) -> Optional[int]:
    """Reset the card's peak-memory gauge; returns the bytes allocated."""
    if not cuda:
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _timed_steps(trainer, batch, steps: int, cuda: bool
                 ) -> Tuple[List[float], List[float]]:
    """`steps` Trainer steps on one batch: (losses, host ms a step; each
    loss is read at once, which waits for the step)."""
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(batch)["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return losses, step_ms


def bert_loss(module, batch, generator, training):
    """Mean MLM cross-entropy over the masked positions, in float32
    (paddle_tpu/benchmark/models.py:_bert)."""
    tokens, positions, lengths, labels = batch
    logits = module(tokens, positions, lengths, generator=generator)
    return softmax_with_cross_entropy(logits.float(), labels).mean(), {}


def _bert_model(bc: dict, layers: int, dtype: torch.dtype,
                device: torch.device) -> BertEncoder:
    dims = dict(vocab=bc["vocab"], model_dim=bc["model_dim"],
                num_heads=bc["num_heads"], num_layers=layers,
                ffn_dim=bc["ffn_dim"], max_len=bc["max_len"])
    model = BertEncoder(**dims, dropout=0.0, dtype=dtype, device=device)
    return load_jax_params(model, bert_tree(SEED + 50, **dims))


def _bert_batch(bc: dict, device: torch.device, seed: int):
    """tokens [B, T], `masked` sorted positions a row inside its length,
    lengths [B] in bc["lengths"] (padding reaches the kernels as segment
    ids), labels [B, masked]."""
    rng = np.random.default_rng(seed)
    b, t, k = bc["batch"], bc["seq"], bc["masked"]
    lo, hi = bc["lengths"]
    lengths = rng.integers(lo, hi + 1, b)
    tokens = rng.integers(0, bc["vocab"], (b, t))
    positions = np.stack([np.sort(rng.choice(n, k, replace=False))
                          for n in lengths])
    labels = rng.integers(0, bc["vocab"], (b, k))
    return tuple(torch.from_numpy(x.astype(np.int32)).to(device)
                 for x in (tokens, positions, lengths, labels))


def _f32_step_vs_plain(build, loss_fn, batch, flash_layers: int,
                       pc: dict, cuda: bool) -> dict:
    """`_step_vs_plain` at f32 on a small batch, as a phase reports it."""
    lp, _, noise, vs = _step_vs_plain(build, loss_fn, batch, flash_layers,
                                      SEED, pc["lr"], cuda)
    return {"flash_layers": flash_layers, "batch": pc["check_batch"],
            "loss_plain": lp, "kernels_vs_plain": vs["kernels"],
            "control_dense_vs_plain": vs["dense"], "loss_bar": 1e-5,
            "grad_bar": 1e-2, "zero_up_to_rounding": noise}


def _check_f32_step(phase: str, rep: dict) -> None:
    """The loss within 1e-5 relative and every gradient within
    train_vs_plain's norm bar, for the kernels and the dense control."""
    for name in ("kernels_vs_plain", "control_dense_vs_plain"):
        r = rep[name]
        check(r["loss_rel_err"] <= 1e-5,
              f"{phase} f32 step loss {name} {r['loss']} vs plain "
              f"{rep['loss_plain']}")
        check(r["grad_worst_over_bar"] <= 1.0,
              f"{phase} {name}: gradient {r['grad_worst_param']} off by "
              f"{r['grad_worst_over_bar']} x its bar")


def phase_bert(cfg: dict, device: torch.device, card: dict) -> dict:
    """BERT-base MLM pretraining (paddle_tpu/benchmark/models.py:_bert's
    widths: vocab 30522, d 768, 12 heads, 12 layers, ffn 3072, T 128,
    19 masked positions, dropout 0) through the port's `Trainer`: a bf16
    model over float32 parameters, Adam 1e-4, the MLM loss in float32, on
    a batch whose lengths leave padding, which reaches the flash kernels
    as segment ids (non-causal). One warm-up step on another batch, then
    `steps` counted steps on one batch: finite losses that fall, and each
    flash kernel launched once per layer per step; tokens a second count
    the real tokens (the lengths) beside the padded count. Then one f32 step at 2
    layers through the kernels, their plain versions and the dense
    control: the loss within 1e-5 relative, the gradients within
    train_vs_plain's norm bar."""
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    bc = cfg["bert"]
    model = _bert_model(bc, bc["num_layers"], torch.bfloat16, device)
    trainer = Trainer(model, Adam(model.parameters(), bc["lr"]), bert_loss,
                      seed=SEED)
    trainer.train_step(_bert_batch(bc, device, SEED + 51))
    batch = _bert_batch(bc, device, SEED + 52)
    start_bytes = _phase_mem(cuda)
    _reset_launches()                               # the path's counts
    losses, step_ms = _timed_steps(trainer, batch, bc["steps"], cuda)
    launches = _expect_launches(FLASH_KERNELS, bc["steps"], bc["num_layers"],
                                cuda)
    med = float(np.median(step_ms))
    out = {"steps": bc["steps"], "batch": bc["batch"], "seq": bc["seq"],
           "masked": bc["masked"], "lengths": batch[2].tolist(),
           "layers": bc["num_layers"], "dtype": "bfloat16", "lr": bc["lr"],
           "losses": losses, "step_ms": step_ms, "step_ms_median": med,
           "tokens_per_s": float(batch[2].sum()) / med * 1e3,
           "padded_tokens_per_s": bc["batch"] * bc["seq"] / med * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "allocated_at_start_bytes": start_bytes,
           "kernel_launches": launches}
    if cuda:
        emit({"phase": "bert_profile", **step_profile(trainer, batch, med),
              "device": card["kind"], "nvidia_smi": card["smi"]})
    del model, trainer

    small = _bert_batch(dict(bc, batch=bc["check_batch"]), device, SEED + 53)

    def build():
        m = _bert_model(bc, 2, torch.float32, device)
        return m, [layer.ffn for layer in m.layers]
    out["f32_step_vs_plain"] = _f32_step_vs_plain(
        build, bert_loss, small, 2, bc, cuda)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit({"phase": "bert", **out, "device": card["kind"],
          "nvidia_smi": card["smi"]})
    _check_f32_step("bert", out["f32_step_vs_plain"])
    return out


def seq2seq_loss(module, batch, generator, training):
    """Token-weighted cross-entropy of the teacher-forced decoder
    (tests/test_transformer.py's recipe), in float32."""
    src, src_lengths, trg_in, trg_out, weights = batch
    logits = module(src, trg_in, src_lengths, generator=generator)
    ce = softmax_with_cross_entropy(logits.float(), trg_out)
    return (ce * weights).sum() / weights.sum(), {}


def _seq2seq_batch(sc: dict, device: torch.device, seed: int):
    """src [B, T] with src_lengths in sc["lengths"] (pad 0 past each),
    trg_in / trg_out [B, T] and weights that cover each row's target
    length (drawn in the same range)."""
    rng = np.random.default_rng(seed)
    b, t, v = sc["batch"], sc["seq"], sc["vocab"]
    lo, hi = sc["lengths"]
    src_len = rng.integers(lo, hi + 1, b)
    trg_len = rng.integers(lo, hi + 1, b)
    pos = np.arange(t)[None]
    src = np.where(pos < src_len[:, None], rng.integers(3, v, (b, t)), 0)
    trg = rng.integers(3, v, (b, t + 1))
    weights = (pos < trg_len[:, None]).astype(np.float32)
    arrays = (src.astype(np.int32), src_len.astype(np.int32),
              trg[:, :-1].astype(np.int32), trg[:, 1:].astype(np.int32),
              weights)
    return tuple(torch.from_numpy(x).to(device) for x in arrays)


def _seq2seq_model(sc: dict, dtype: torch.dtype,
                   device: torch.device) -> Transformer:
    return Transformer(sc["vocab"], sc["vocab"], model_dim=sc["model_dim"],
                       num_heads=sc["num_heads"], num_layers=sc["num_layers"],
                       ffn_dim=sc["ffn_dim"], dropout=0.0,
                       max_len=sc["max_len"], dtype=dtype, device=device)


def _greedy_dense(model, memory, src_mask, new: int, bos: int):
    """`new` greedy tokens through decode_step over a dense cache:
    (tokens [B, new], each step's top-2 logit gap [B, new])."""
    b = memory.shape[0]
    caches = model.init_cache(b, max_len=new)
    tok = torch.full((b,), bos, dtype=torch.long, device=memory.device)
    toks, gaps = [], []
    for t in range(new):
        logits, caches = model.decode_step(tok, t, memory, caches, src_mask)
        tok = logits.argmax(-1)
        toks.append(tok)
        gaps.append(_top2_gap(logits))
    return torch.stack(toks, 1), torch.stack(gaps, 1)


def _greedy_paged(model, memory, src_mask, new: int, bos: int, bs: int):
    """The same through decode_step_paged: each sequence's decoder k/v in
    its own blocks of `bs` positions (tables in order from block 1)."""
    b, dev = memory.shape[0], memory.device
    mb = -(-new // bs)
    tables = torch.arange(1, 1 + b * mb, dtype=torch.int32,
                          device=dev).reshape(b, mb)
    attn = model.dec_layers[0].self_attn
    shape = (1 + b * mb, bs, attn.num_kv_heads, attn.head_dim)
    pools = [(torch.zeros(shape, dtype=model.dtype, device=dev),
              torch.zeros(shape, dtype=model.dtype, device=dev))
             for _ in model.dec_layers]
    tok = torch.full((b,), bos, dtype=torch.long, device=dev)
    toks, gaps = [], []
    for t in range(new):
        pos = torch.full((b,), t, dtype=torch.int32, device=dev)
        slots = tables[:, t // bs].long() * bs + t % bs
        logits = model.decode_step_paged(tok, pos, memory, pools, tables,
                                         pos + 1, slots, src_mask)
        tok = logits.argmax(-1)
        toks.append(tok)
        gaps.append(_top2_gap(logits))
    return torch.stack(toks, 1), torch.stack(gaps, 1)


def phase_seq2seq(cfg: dict, device: torch.device, card: dict) -> dict:
    """Transformer-base WMT (paddle_tpu/benchmark/models.py:_transformer's
    widths: vocab 32000 both sides, d 512, 8 heads, 6 + 6 layers, ffn
    2048, T 256, max_len 257, dropout 0) through the port's `Trainer`:
    bf16 over float32 parameters, Adam 1e-4, source lengths that leave
    padding. One warm-up step on another batch, then `steps` steps on one
    batch: finite losses that fall; each flash kernel launched once per
    encoder layer (segment ids from src_lengths) and once per decoder
    self-attention layer (causal) a step, and never for the
    cross-attention, which takes the dense src_mask as JAX's dispatch
    does. Then, with the trained weights in f32, on 4 sources:
    - `beam_search` over `decode_step` (K 4, `decode` tokens, length
      penalty 0.6) with early_exit off and on: equal results, sorted
      finite scores, lengths within max_len;
    - `decode` greedy tokens through `decode_step` and through
      `decode_step_paged` (block 16): the streams equal up to the first
      position where either path's top-2 logits lie within 1e-4 (such
      splits are counted), and the paged-decode kernel launched once
      per decoder layer per token.
    Then one f32 step at 2 + 2 layers through the kernels, their plain
    versions and the dense control, held as `bert`'s. Throughput counts
    real tokens (target weights, source lengths) beside the padded
    count."""
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sc = cfg["seq2seq"]
    layers = sc["num_layers"]
    tree = transformer_tree(SEED + 60, sc["vocab"], sc["vocab"],
                            sc["model_dim"], sc["num_heads"], layers,
                            sc["ffn_dim"])
    model = load_jax_params(_seq2seq_model(sc, torch.bfloat16, device), tree)
    trainer = Trainer(model, Adam(model.parameters(), sc["lr"]),
                      seq2seq_loss, seed=SEED)
    trainer.train_step(_seq2seq_batch(sc, device, SEED + 61))
    batch = _seq2seq_batch(sc, device, SEED + 62)
    start_bytes = _phase_mem(cuda)
    _reset_launches()                               # the path's counts
    losses, step_ms = _timed_steps(trainer, batch, sc["steps"], cuda)
    # 6 encoder + 6 decoder self-attention layers; the cross-attention
    # under the dense src_mask launches none
    launches = _expect_launches(FLASH_KERNELS, sc["steps"], 2 * layers, cuda)
    med = float(np.median(step_ms))
    out = {"steps": sc["steps"], "batch": sc["batch"], "seq": sc["seq"],
           "layers": f"{layers} + {layers}", "dtype": "bfloat16",
           "lr": sc["lr"], "src_lengths": batch[1].tolist(),
           "losses": losses, "step_ms": step_ms, "step_ms_median": med,
           "target_tokens_per_s": float(batch[4].sum()) / med * 1e3,
           "src_tokens_per_s": float(batch[1].sum()) / med * 1e3,
           "padded_tokens_per_s": sc["batch"] * sc["seq"] / med * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "allocated_at_start_bytes": start_bytes,
           "kernel_launches": launches}
    if cuda:
        emit({"phase": "seq2seq_profile",
              **step_profile(trainer, batch, med), "device": card["kind"],
              "nvidia_smi": card["smi"]})

    trained = to_jax_params(model)
    del model, trainer
    f32 = load_jax_params(_seq2seq_model(sc, torch.float32, device), trained)
    n, k, new, bos, eos = sc["sources"], sc["beam"], sc["decode"], 1, 2
    src, src_len = batch[0][:n], batch[1][:n]
    with torch.inference_mode():
        memory, src_mask = f32.encode(src, src_len)
        memory_t, mask_t = tile_beams(memory, k), tile_beams(src_mask, k)

        def decode_fn(tokens, pos, caches):
            return f32.decode_step(tokens, pos, memory_t, caches, mask_t)
        beams, beam_ms = {}, {}
        for early in (False, True):
            sync()
            t0 = time.perf_counter()
            beams[early] = beam_search(
                decode_fn, f32.init_cache(n * k, max_len=new), batch=n,
                beam_size=k, max_len=new, bos_id=bos, eos_id=eos,
                vocab_size=sc["vocab"], length_penalty=0.6,
                early_exit=early)
            sync()
            beam_ms[str(early)] = (time.perf_counter() - t0) * 1e3
        sync()
        t0 = time.perf_counter()
        dense, dense_gaps = _greedy_dense(f32, memory, src_mask, new, bos)
        sync()
        dense_ms = (time.perf_counter() - t0) * 1e3
        _reset_launches()                           # kernel 3's count
        t0 = time.perf_counter()
        paged, paged_gaps = _greedy_paged(f32, memory, src_mask, new, bos,
                                          sc["block_size"])
        sync()
        paged_ms = (time.perf_counter() - t0) * 1e3
    paged_launches = _expect_launches("paged_attention", new, layers, cuda)
    full, early = beams[False], beams[True]
    same = all(torch.equal(a, b) for a, b in zip(full, early))
    scores = full.scores.float()
    rows = [_stream_split(dense[i].tolist(), paged[i].tolist(),
                          dense_gaps[i].tolist(), paged_gaps[i].tolist(),
                          1e-4) for i in range(n)]
    out.update({
        "decode_dtype": "float32", "sources": n, "src_lengths_decoded":
        src_len.tolist(), "beam": {
            "k": k, "max_len": new, "length_penalty": 0.6,
            "early_exit_equal": same, "scores": scores.tolist(),
            "lengths": full.lengths.tolist(), "ms": beam_ms},
        "greedy": {"tokens": new, "block_size": sc["block_size"],
                   "dense_ms": dense_ms, "paged_ms": paged_ms,
                   "rows": rows,
                   "splits": [r for r in rows if r["agreed"] < new]},
        "paged_kernel_launches": paged_launches})
    del f32
    small = _seq2seq_batch(dict(sc, batch=sc["check_batch"]), device,
                           SEED + 63)
    small_tree = transformer_tree(SEED + 64, sc["vocab"], sc["vocab"],
                                  sc["model_dim"], sc["num_heads"], 2,
                                  sc["ffn_dim"])

    def build():
        m = load_jax_params(_seq2seq_model(dict(sc, num_layers=2),
                                           torch.float32, device), small_tree)
        return m, [layer.ffn for layer in (*m.enc_layers, *m.dec_layers)]
    # 2 encoder + 2 decoder self-attention layers through the kernels
    out["f32_step_vs_plain"] = _f32_step_vs_plain(
        build, seq2seq_loss, small, 4, sc, cuda)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit({"phase": "seq2seq", **out, "device": card["kind"],
          "nvidia_smi": card["smi"]})
    _check_f32_step("seq2seq", out["f32_step_vs_plain"])
    check(same, "beam_search with early_exit differs from the full run")
    check(bool(torch.isfinite(scores).all()), "non-finite beam scores")
    check(bool((scores[:, :-1] >= scores[:, 1:]).all()),
          "beam scores not sorted")
    check(int(full.lengths.max()) <= new, "a beam longer than max_len")
    check(all(r["ok"] for r in rows),
          f"paged greedy stream left the dense one away from a near tie: "
          f"{rows}")
    return out


# -- configurations -------------------------------------------------------

# -- the op library's sweep ---------------------------------------------

def _device_ms(fn, iters: int, cuda: bool) -> List[float]:
    """Each of `iters` calls of fn, ms, after one warm-up: on the device
    clock (CUDA events around the call) on the card, the host's off it."""
    fn()
    out = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def trace_counts(prof) -> dict:
    """A trace's host kernel launches (`cudaLaunchKernel*`) and the
    device's kernels, memsets and copies, and their busy time."""
    device = device_activities(prof)
    return {"host_launches": sum(1 for e in prof.events()
                                 if e.name.startswith("cudaLaunchKernel")),
            "device_kernels": sum(1 for e in device
                                  if not e.name.startswith("Mem")),
            "device_memsets_copies": sum(1 for e in device
                                         if e.name.startswith("Mem")),
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in device) / 1e3}


def launches_per_call(fn, cuda: bool) -> Optional[dict]:
    """`trace_counts` of one call of fn under `torch.profiler`."""
    if not cuda:
        return None
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return trace_counts(prof)


def ssd_inputs(sc: dict, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD300's detection-output inputs on the CPU: the priors of its six
    layers (`prior_box`), decoded (`box_coder`, variances 0.1 / 0.2)
    from seeded deltas, and a seeded softmax over the classes. Returns
    (boxes [P, 4], scores [classes, P])."""
    boxes, var = [], []
    for fm, step, lo, hi, ratios in zip(sc["maps"], sc["steps"],
                                        sc["min_sizes"], sc["max_sizes"],
                                        sc["ratios"]):
        b, v = detection.prior_box((fm, fm), (sc["image"], sc["image"]),
                                   [lo], [hi], ratios, step=(step, step),
                                   device="cpu")
        boxes.append(b.reshape(-1, 4))
        var.append(v.reshape(-1, 4))
    priors, var = torch.cat(boxes), torch.cat(var)
    check(priors.shape[0] == sc["priors"], f"ssd: {priors.shape[0]} priors")
    g = torch.Generator().manual_seed(seed)
    deltas = torch.randn(priors.shape, generator=g)
    logits = 2.0 * torch.randn((priors.shape[0], sc["classes"]), generator=g)
    return (detection.box_coder(priors, var, deltas, "decode"),
            torch.softmax(logits, -1).T.contiguous())


def _nms_near(boxes: torch.Tensor, scores: torch.Tensor, sc: dict,
              tol: float = 1e-6) -> bool:
    """Whether any pairwise IoU or any score lies within tol of its
    threshold (where two devices' last bits may pick differently)."""
    iou = detection.iou_similarity(boxes, boxes)
    return bool((iou - sc["nms_threshold"]).abs().le(tol).any()
                or (scores - sc["score_threshold"]).abs().le(tol).any())


def ctc_inputs(cc: dict, seed: int):
    """DeepSpeech2-shaped CTC inputs on the CPU: seeded logits [B, T, V],
    labels [B, 80] of 20-80 symbols in 1..V-1 (0 is blank) and their
    lengths."""
    g = torch.Generator().manual_seed(seed)
    b, t, v = cc["batch"], cc["frames"], cc["symbols"]
    lo, hi = cc["labels"]
    logits = torch.randn((b, t, v), generator=g)
    lab_len = torch.randint(lo, hi + 1, (b,), generator=g)
    labels = torch.randint(1, v, (b, hi), generator=g)
    labels = torch.where(torch.arange(hi)[None, :] < lab_len[:, None],
                         labels, torch.zeros_like(labels))
    return logits, labels, torch.full((b,), t, dtype=torch.int64), lab_len


def phase_ops_sweep(cfg: dict, device: torch.device, card: dict) -> dict:
    """The op library's modules that brought no kernel, on the card:
    (a) every case of `op_cases` on the card against the CPU (tensors on
    the card, integers equal, floats within 1e-5; an NMS-family output
    may differ only where a deciding IoU or score lies within 1e-6 of
    its threshold, counted); (b) `multiclass_nms` at SSD300's
    detection-output settings, equal to the CPU run under (a)'s rule;
    (c) `ctc_loss` forward and backward at DeepSpeech2's alphabet, loss
    and gradient within 1e-5 relative of the CPU run. (b) and (c): the
    median of `op_iters` calls after one warm-up on the device clock,
    and one call's launches under `torch.profiler`."""
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    sweep = op_cases.sweep(device)
    out = {"ops_swept": sweep["ops"], "cases": sweep["swept"],
           "near_threshold": sweep["near_threshold"]}

    sc = cfg["ssd"]
    boxes, scores = ssd_inputs(sc, SEED + 90)
    args = (sc["score_threshold"], sc["nms_threshold"], sc["nms_top_k"],
            sc["keep_top_k"], 0)
    want, want_n = detection.multiclass_nms(boxes, scores, *args)
    boxes_d, scores_d = boxes.to(device), scores.to(device)

    def nms_call():
        return detection.multiclass_nms(boxes_d, scores_d, *args)
    got, got_n = nms_call()
    check(got.device.type == device.type, "ssd: output off the device")
    same = torch.equal(got.cpu(), want) and int(got_n) == int(want_n)
    near = not same and _nms_near(boxes_d, scores_d, sc)
    check(same or near, f"ssd: card and CPU differ, count {int(got_n)} vs "
          f"{int(want_n)}, no IoU or score near its threshold")
    ms = _device_ms(nms_call, cfg["op_iters"], cuda)
    out["ssd_multiclass_nms"] = {
        "priors": boxes.shape[0], "classes": sc["classes"],
        "kept": int(want_n), "equal_to_cpu": same, "near_threshold": near,
        "ms": float(np.median(ms)), "ms_each": ms,
        "clock": "CUDA events" if cuda else "host (no card)",
        "launches": launches_per_call(nms_call, cuda)}
    out["near_threshold"] += int(near)

    cc = cfg["ctc"]
    logits, labels, in_len, lab_len = ctc_inputs(cc, SEED + 91)

    def ctc_grad(x, lab, il, ll):
        x = x.detach().requires_grad_(True)
        loss = lattice.ctc_loss(torch.log_softmax(x, -1), lab, il, ll)
        (g,) = torch.autograd.grad(loss.sum(), x)
        return loss.detach(), g
    want_l, want_g = ctc_grad(logits, labels, in_len, lab_len)
    dev_args = [a.to(device) for a in (logits, labels, in_len, lab_len)]
    got_l, got_g = ctc_grad(*dev_args)
    check(got_l.device.type == device.type, "ctc: output off the device")
    loss_gap = float(((got_l.cpu() - want_l).abs()
                      / want_l.abs().clamp(min=1.0)).max())
    grad_gap = float((got_g.cpu() - want_g).abs().max()
                     / want_g.abs().max())
    check(loss_gap <= 1e-5 and grad_gap <= 1e-5 and
          bool(torch.isfinite(got_l).all()),
          f"ctc: card vs CPU loss {loss_gap:.3g}, grad {grad_gap:.3g}")
    ms = _device_ms(lambda: ctc_grad(*dev_args), cfg["op_iters"], cuda)
    out["ctc_loss_fwd_bwd"] = {
        "batch": cc["batch"], "frames": cc["frames"],
        "symbols": cc["symbols"], "label_lengths": lab_len.tolist(),
        "loss_mean": float(want_l.mean()), "loss_rel_gap": loss_gap,
        "grad_rel_gap": grad_gap, "ms": float(np.median(ms)), "ms_each": ms,
        "clock": "CUDA events" if cuda else "host (no card)",
        "launches": launches_per_call(lambda: ctc_grad(*dev_args), cuda)}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "ops_sweep", **out, "device": card["kind"],
          "nvidia_smi": card["smi"]})
    return out


# -- the model zoo --------------------------------------------------------

ZOO_BF16_PEAK = CARD_PEAK_FLOPS["NVIDIA H100 80GB HBM3"][16]
CONV_NAME_KEYS = ("fprop", "dgrad", "wgrad", "conv", "implicit_gemm")
LAYOUT_NAME_KEYS = ("nchwtonhwc", "nhwctonchw", "transpose_readwrite")


def forward_flops(model, *inputs) -> float:
    """6 x the multiply-adds of one forward's convolutions and Linears
    (2 a multiply-add, x3 for forward and backward), counted from their
    shapes by forward hooks on one eval-mode forward."""
    macs = [0]

    def conv_hook(m, inp, out):
        kh, kw, cin, _ = m.weight.shape
        macs[0] += out.numel() * kh * kw * cin

    def linear_hook(m, inp, out):
        macs[0] += out.numel() * m.in_features

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, Conv2D)]
    hooks += [m.register_forward_hook(linear_hook) for m in model.modules()
              if isinstance(m, Linear)]
    was = model.training
    with torch.no_grad():
        model.eval()(*inputs)
    model.train(was)
    for h in hooks:
        h.remove()
    return 6.0 * macs[0]


ZOO_GROUPS = ("conv", "layout", "gemm", "bn_elementwise", "optimizer")
# the small lr at which `resnet50_witness` runs bf16 again
WITNESS_LR = 0.01


def zoo_kernel_group(name: str, in_optimizer: bool) -> str:
    """A kernel's group in a vision or RNN step: the optimizer's update,
    a layout transform (NCHW <-> NHWC; none while the convolutions run
    channels-last), a convolution, a GEMM, or BatchNorm and the other
    elementwise kernels."""
    low = name.lower()
    if in_optimizer:
        return "optimizer"
    if any(k in low for k in LAYOUT_NAME_KEYS):
        return "layout"
    if any(k in low for k in CONV_NAME_KEYS) or "cudnn" in low:
        return "conv"
    if any(k in low for k in GEMM_NAME_KEYS):
        return "gemm"
    return "bn_elementwise"


def classify_loss(module, batch, generator, training):
    """Mean softmax cross-entropy of the logits in float32
    (paddle_tpu/benchmark/models.py's image and LSTM specs)."""
    x, y = batch
    return softmax_with_cross_entropy(module(x).float(), y).mean(), {}


def _zoo_step(build, batch, device: torch.device, tree: dict,
              cudnn: bool = True) -> dict:
    """One Momentum(0.1, 0.9) Trainer step of a model made by `build`
    on `device` from `tree`: the loss, every gradient and the new
    buffers (on the CPU)."""
    model = load_jax_params(build(device), tree)
    trainer = Trainer(model, optim.Momentum(model.parameters(), 0.1,
                                            momentum=0.9), classify_loss)
    cd = torch.backends.cudnn       # flags() resets what it is not given
    with cd.flags(enabled=cudnn, benchmark=cd.benchmark,
                  deterministic=cd.deterministic, allow_tf32=cd.allow_tf32):
        loss = float(trainer.train_step(tuple(t.to(device) for t in batch))
                     ["loss"])
    return {"loss": loss,
            "grads": {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()},
            "buffers": {n: b.detach().cpu() for n, b in
                        model.named_buffers()}}


def zoo_step_vs_cpu(zc: dict, device: torch.device) -> dict:
    """One f32 training step of ResNet((1, 1, 1, 1)) on the card and on
    the CPU from the same weights and batch, and a control on the card
    with cuDNN off (PyTorch's own CUDA convolutions: another float32
    order). The loss within 1e-4 relative; the gradients in norm by
    `_grad_gap`'s bar (ReLU gates flip on float32 noise), the tensors
    whose gradient is 0 up to rounding taken out by the control; the
    BatchNorm buffers within 1e-4 of their largest element."""
    sc = zc["step"]
    torch.manual_seed(SEED + 60)

    def build(dev):
        return ResNet(tuple(sc["layers"]), num_classes=sc["classes"],
                      device=dev)
    tree = to_jax_params(build("cpu"))
    g = torch.Generator().manual_seed(SEED + 61)
    batch = (torch.randn((sc["batch"], sc["image"], sc["image"], 3),
                         generator=g),
             torch.randint(0, sc["classes"], (sc["batch"],), generator=g))
    cpu = _zoo_step(build, batch, torch.device("cpu"), tree)
    card = _zoo_step(build, batch, device, tree)
    control = _zoo_step(build, batch, device, tree, cudnn=False)
    noise = _noise_only(cpu["grads"], control["grads"])
    out = {"layers": sc["layers"], "image": sc["image"],
           "batch": sc["batch"], "loss_cpu": cpu["loss"],
           "zero_up_to_rounding": noise}
    for name, run in (("card_vs_cpu", card), ("control_vs_cpu", control)):
        rel = abs(run["loss"] - cpu["loss"]) / abs(cpu["loss"])
        buf = max(nn_cases.gap(run["buffers"][n], b)
                  for n, b in cpu["buffers"].items())
        out[name] = {"loss": run["loss"], "loss_rel_err": rel,
                     "buffers_worst_rel_err": buf,
                     **_grad_gap(run["grads"], cpu["grads"], noise)}
        check(rel <= 1e-4, f"zoo step {name}: loss {run['loss']} vs "
              f"{cpu['loss']}")
        check(buf <= 1e-4, f"zoo step {name}: BN buffers off by {buf}")
        check(out[name]["grad_worst_over_bar"] <= 1.0,
              f"zoo step {name}: gradient {out[name]['grad_worst_param']} "
              f"{out[name]['grad_worst_over_bar']} x its bar")
    return out


def _grad_dot(a: Dict[str, torch.Tensor],
              b: Dict[str, torch.Tensor]) -> float:
    """The dot product of two gradients, every tensor as one vector."""
    return sum(float((a[n].double() * b[n].double()).sum()) for n in a)


def _grad_cosine(a: Dict[str, torch.Tensor],
                 b: Dict[str, torch.Tensor]) -> float:
    return _grad_dot(a, b) / (_grad_dot(a, a) * _grad_dot(b, b)) ** 0.5


def _resnet_run(rc: dict, device: torch.device, start: dict, batch,
                dtype: torch.dtype, lr: float, steps: int):
    """`steps` Momentum(lr, 0.9) steps of the `rc` ResNet in `dtype` from
    the weights and buffers `start` on `batch`: (each step's loss, the
    first step's gradients)."""
    model = ResNet(tuple(rc["layers"]), num_classes=rc["classes"],
                   dtype=dtype, device=device)
    model.load_state_dict(start)
    trainer = Trainer(model, optim.Momentum(model.parameters(), lr,
                                            momentum=0.9), classify_loss)
    losses = [float(trainer.train_step(batch)["loss"])]
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    losses += [float(trainer.train_step(batch)["loss"])
               for _ in range(steps - 1)]
    return losses, grads


def resnet50_witness(rc: dict, device: torch.device, start: dict, batch,
                     losses: List[float], grads: dict) -> dict:
    """What backs the bf16 run's numbers, from its first weights and its
    batch: (1) the same steps in float32 (TF32 off) at the same lr, its
    first two losses within 5e-2 relative of bf16's (bf16 keeps 8 bits,
    over 53 convolutions and norms; the second loss is the first that
    the backward moves), beside bf16's losses; the gradients' norms and
    the cosine of bf16's first gradient with float32's, and, as its
    scale, of float32's with float32's on the input shaken by 2^-9
    relative (bf16's rounding); (2) the same steps in bf16 at
    WITNESS_LR, whose loss falls (the bf16 backward descends)."""
    n = len(losses)
    f32, g32 = _resnet_run(rc, device, start, batch, torch.float32, 0.1,
                           n)
    x, y = batch
    g = torch.Generator(device=x.device).manual_seed(SEED + 66)
    shaken = x * (1 + 2.0 ** -9 * torch.randn(x.shape, generator=g,
                                              device=x.device))
    _, g_shaken = _resnet_run(rc, device, start, (shaken, y),
                              torch.float32, 0.1, 1)
    small, _ = _resnet_run(rc, device, start, batch, rc["dtype"],
                           WITNESS_LR, n)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:2], f32)]
    out = {"steps": n, "f32_losses": f32, "first_losses_rel_err": rel,
           "grad_norm": _grad_dot(grads, grads) ** 0.5,
           "f32_grad_norm": _grad_dot(g32, g32) ** 0.5,
           "grad_cosine_vs_f32": _grad_cosine(grads, g32),
           "f32_grad_cosine_shaken_input": _grad_cosine(g_shaken, g32),
           "witness_lr": WITNESS_LR, "witness_losses": small}
    check(max(rel) <= 5e-2, f"resnet witness: first losses {losses[:2]} "
          f"against float32's {f32[:2]}")
    check(all(np.isfinite(small)) and small[-1] < small[0],
          f"resnet witness: at lr {WITNESS_LR} the loss went "
          f"{small}")
    return out


def zoo_resnet50(zc: dict, device: torch.device) -> dict:
    """ResNet-50 training at paddle_tpu/benchmark/models.py's `resnet50`
    spec: 224x224x3 seeded inputs and labels over 1000 classes, bf16
    compute over float32 parameters, Momentum(0.1, 0.9), softmax
    cross-entropy in float32. Warm-up steps, then timed steps on the
    repeated batch (host clock around each synchronised step); one more
    step traced; the step's FLOP bound; `resnet50_witness` from the
    same first weights."""
    cuda = device.type == "cuda"
    rc = zc["resnet"]
    torch.manual_seed(SEED + 62)
    model = ResNet(tuple(rc["layers"]), num_classes=rc["classes"],
                   dtype=rc["dtype"], device=device)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator(device=device).manual_seed(SEED + 63)
    b, img = rc["batch"], rc["image"]
    batch = (torch.randn((b, img, img, 3), generator=g, device=device),
             torch.randint(0, rc["classes"], (b,), generator=g,
                           device=device))
    flops = forward_flops(model, batch[0])
    trainer = Trainer(model, optim.Momentum(model.parameters(), 0.1,
                                            momentum=0.9), classify_loss)
    warm = []
    for i in range(rc["warmup"]):
        warm.append(float(trainer.train_step(batch)["loss"]))
        if i == 0:
            first_grads = {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}
    _phase_mem(cuda)
    losses, step_ms = [], []
    for _ in range(rc["steps"]):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(batch)["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"resnet: non-finite losses {losses}")
    med = float(np.median(step_ms))
    bound = flops / ZOO_BF16_PEAK * 1e3
    out = {"layers": rc["layers"], "batch": b, "image": img,
           "classes": rc["classes"],
           "dtype": f"{str(rc['dtype'])[6:]} compute, float32 parameters",
           "optimizer": "Momentum(0.1, momentum=0.9)",
           "warmup": rc["warmup"], "warmup_losses": warm, "losses": losses,
           "step_ms": step_ms,
           "step_ms_median": med, "imgs_per_s": b / med * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "step_flops": flops, "bound_ms": bound,
           "bound_by": "operations (bf16 peak 989.4 TFLOP/s)",
           "step_over_bound": med / bound}
    if cuda:
        prof = step_profile(trainer, batch, med, zoo_kernel_group,
                            ZOO_GROUPS)
        out.update(profile=prof, launches_per_step=prof["host_launches"],
                   channels_last=prof["kernels_by_group"]["layout"] == 0)
    del trainer, model
    out["witness"] = resnet50_witness(rc, device, start, batch,
                                      warm + losses, first_grads)
    return out


def zoo_lstm(zc: dict, device: torch.device) -> dict:
    """The stacked-LSTM classifier at models.py's `stacked_lstm` spec:
    `TextClassifier`, float32, Adam 1e-3, seeded tokens and 2-class
    labels; one warm-up step, then timed steps; one more traced."""
    cuda = device.type == "cuda"
    lc = zc["lstm"]
    torch.manual_seed(SEED + 64)
    model = TextClassifier(vocab=lc["vocab"], embed_dim=lc["embed"],
                           hidden=lc["hidden"], layers=lc["layers"],
                           device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 65)
    b, t = lc["batch"], lc["seq"]
    batch = (torch.randint(0, lc["vocab"], (b, t), generator=g,
                           device=device),
             torch.randint(0, 2, (b,), generator=g, device=device))
    trainer = Trainer(model, Adam(model.parameters(), 1e-3), classify_loss)
    trainer.train_step(batch)
    _phase_mem(cuda)
    losses, step_ms = [], []
    for _ in range(lc["steps"]):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(batch)["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"lstm: non-finite losses {losses}")
    med = float(np.median(step_ms))
    out = {"vocab": lc["vocab"], "embed": lc["embed"],
           "hidden": lc["hidden"], "layers": lc["layers"], "batch": b,
           "seq": t, "dtype": "float32", "optimizer": "Adam(1e-3)",
           "losses": losses, "step_ms": step_ms, "ms_per_batch": med,
           "tokens_per_s": b * t / med * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}
    if cuda:
        prof = step_profile(trainer, batch, med, zoo_kernel_group,
                            ZOO_GROUPS)
        out.update(launches_per_step=prof["host_launches"],
                   idle_share=prof["idle_share"],
                   device_busy_ms=prof["device_busy_ms"],
                   busy_ms_by_group=prof["busy_ms_by_group"])
    return out


def phase_zoo(cfg: dict, device: torch.device, card: dict) -> dict:
    """The nn layers and the model zoo, which bring no kernel of their
    own (cuDNN's convolutions, PyTorch's ops): (a) every case of
    `testing.nn_cases` on the card against the CPU (each output,
    gradient and buffer within 1e-4 of its largest element), then one
    ResNet((1, 1, 1, 1)) training step against the CPU; (b) ResNet-50
    training at the repo's `resnet50` spec; (c) the stacked-LSTM
    classifier at its `stacked_lstm` spec."""
    zc = cfg["zoo"]
    t_phase = time.perf_counter()
    layers = nn_cases.sweep(device)
    out = {"layers_worst_over_bar": {k: v["worst"] for k, v in
                                     layers.items()},
           "layers_bar": nn_cases.BAR,
           "resnet_step": zoo_step_vs_cpu(zc, device)}
    tag = {"device": card["kind"], "nvidia_smi": card["smi"]}
    emit({"phase": "zoo", "part": "layers", **out, **tag})
    out["resnet50"] = zoo_resnet50(zc, device)
    emit({"phase": "zoo", "part": "resnet50", **out["resnet50"], **tag})
    out["stacked_lstm"] = zoo_lstm(zc, device)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "zoo", "part": "stacked_lstm", **out["stacked_lstm"],
          "zoo_seconds": out["seconds"], **tag})
    return out


# -- quant/, the inference export and data/ ------------------------------

def _int8_resnet(qc: dict, device: torch.device) -> dict:
    """ResNet-50 inference at bench.py's `_int8_compute_bench` spec: 1000
    classes, 224x224x3 inputs from RandomState(0), float32 parameters;
    four variants of the same weights — float32, bf16, and the bf16 model
    frozen to int8 with dynamic activation scales and with static ones
    from one calibration batch (the batch itself) — each timed (median of
    `iters` calls after a warm-up, CUDA events) with its peak memory; the
    int8 variants' top-1 agreement with bf16 and max relative logit error
    (bench.py's two numbers), held to tests/test_int8_compute.py:84-85's
    bars (>= 0.75, < 0.15); the weight bytes (`quantized_nbytes`)."""
    cuda = device.type == "cuda"
    torch.manual_seed(SEED + 80)
    f32 = ResNet(tuple(qc["layers"]), qc["classes"], device=device)
    bf16 = load_jax_params(
        ResNet(tuple(qc["layers"]), qc["classes"], dtype=torch.bfloat16,
               device=device), to_jax_params(f32))
    rs = np.random.RandomState(0)
    img = qc["image"]
    out = {"layers": qc["layers"], "image": img, "classes": qc["classes"],
           "weight_bytes": {"float32": quant.quantized_nbytes(
               to_jax_params(f32)["params"])}}
    for bs in qc["batches"]:
        x = torch.from_numpy(rs.randn(bs, img, img, 3).astype(np.float32)
                             ).to(device)
        dyn, tree = freeze_int8(copy.deepcopy(bf16))
        static, _ = freeze_int8(copy.deepcopy(bf16), None, [x])
        out["weight_bytes"]["int8"] = quant.quantized_nbytes(tree["params"])
        row = {}
        with torch.no_grad():
            ref = bf16(x).float()
            for name, m in (("float32", f32), ("bfloat16", bf16),
                            ("int8_dynamic", dyn), ("int8_static", static)):
                start = _phase_mem(cuda)
                ms = float(np.median(_device_ms(lambda: m(x), qc["iters"],
                                                cuda)))
                r = {"ms": ms, "imgs_per_s": bs / ms * 1e3,
                     "peak_bytes": (torch.cuda.max_memory_allocated()
                                    if cuda else None),
                     "peak_bytes_above_start": (
                         torch.cuda.max_memory_allocated() - start
                         if cuda else None)}
                if name.startswith("int8"):
                    got = m(x).float()
                    r["top1_agree_bf16"] = float(
                        (got.argmax(-1) == ref.argmax(-1)).float().mean())
                    r["max_rel_logit_err_bf16"] = nn_cases.gap(got, ref)
                    check(r["top1_agree_bf16"] >= 0.75
                          and r["max_rel_logit_err_bf16"] < 0.15,
                          f"resnet50 {name} B {bs}: agreement "
                          f"{r['top1_agree_bf16']}, relative error "
                          f"{r['max_rel_logit_err_bf16']}")
                row[name] = r
            row["int8_static_vs_bf16_ms"] = (row["int8_static"]["ms"]
                                             / row["bfloat16"]["ms"])
            if bs == qc["batches"][-1]:
                row["profile"] = {name: inference_profile(lambda: m(x), cuda)
                                  for name, m in (("bfloat16", bf16),
                                                  ("int8_static", static))}
        out[f"b{bs}"] = row
        del dyn, static
    return out


def inference_profile(fn, cuda: bool) -> Optional[dict]:
    """One traced call of fn: the card's busy ms, of it the GEMMs'
    (cuBLAS and CUTLASS kernels, the int8 ones included), the kernel and
    launch counts, and the eight kernels that took longest."""
    if not cuda:
        return None
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = device_events(prof)
    gemm = sum(us for name, us in by_name.items()
               if any(k in name.lower() for k in GEMM_NAME_KEYS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {**trace_counts(prof), "gemm_ms": gemm / 1e3,
            "top_kernels_ms": {name[:90]: us / 1e3 for name, us in top}}


def _int8_lm_head(qc: dict, device: torch.device) -> dict:
    """The int8 LM head: `Int8Linear` (dynamic activation scales) against
    a bf16 `Linear` of the same float32 weights at the shape of
    int8_compute.py's docstring, [4096, 512] x [512, 32000]: ms (median
    after a warm-up, CUDA events) and the int8 output's relative error
    against bf16's."""
    cuda = device.type == "cuda"
    rows, d, v = qc["head"]
    torch.manual_seed(SEED + 81)
    head = Linear(d, v, dtype=torch.bfloat16, device=device)
    x = torch.randn(rows, d, device=device)
    q = Int8Linear.from_float(head)
    with torch.no_grad():
        ref, got = head(x), q(x)
        ms = {name: float(np.median(_device_ms(lambda: m(x), qc["iters"],
                                               cuda)))
              for name, m in (("bfloat16", head), ("int8", q))}
    return {"shape": [rows, d, v], "ms": ms,
            "int8_vs_bf16_ms": ms["int8"] / ms["bfloat16"],
            "max_rel_err_bf16": nn_cases.gap(got, ref)}


def phase_quant(cfg: dict, device: torch.device, card: dict) -> dict:
    """quant/ on the card, which brings no kernel of its own (the int8
    GEMMs are `torch._int_mm`, as JAX's are XLA int8 dots): (a) every case
    of `testing.quant_cases` on the card against the CPU (int8 and int32
    equal, floats within 1e-6 of their largest element); (b) ResNet-50 int8
    inference (`_int8_resnet`); (c) the int8 LM head (`_int8_lm_head`)."""
    qc = cfg["quant"]
    tag = {"device": card["kind"], "nvidia_smi": card["smi"]}
    t_phase = time.perf_counter()
    cases = quant_cases.sweep(device)
    out = {"cases": cases}
    emit({"phase": "quant", "part": "cases", "swept": len(cases),
          "worst_float_err": max(cases.values()),
          "float_bar": quant_cases.FLOAT_BAR, "by_case": cases, **tag})
    out["resnet50"] = _int8_resnet(qc, device)
    emit({"phase": "quant", "part": "resnet50", **out["resnet50"], **tag})
    out["lm_head"] = _int8_lm_head(qc, device)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "quant", "part": "lm_head", **out["lm_head"],
          "quant_seconds": out["seconds"], **tag})
    return out


class BertHidden(torch.nn.Module):
    """`BertEncoder`'s hidden states over (tokens, lengths): the exported
    entry point."""

    def __init__(self, bert: BertEncoder):
        super().__init__()
        self.bert = bert

    def forward(self, tokens, lengths):
        return self.bert(tokens, lengths=lengths)


def _graph_ops(program) -> Dict[str, int]:
    """Calls in an exported program's graph: of kernel 4's operator, and
    of any softmax (a dense attention would hold one)."""
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    return {"flash_fwd_op": sum("paddle_tpu_torch.flash_fwd" in t
                                for t in targets),
            "softmax": sum("softmax" in t for t in targets)}


def _export_resnet(ec: dict, device: torch.device, root: Path) -> dict:
    torch.manual_seed(SEED + 82)
    model = ResNet(tuple(ec["resnet_layers"]), ec["classes"], device=device)
    x = np.random.RandomState(1).randn(
        ec["resnet_batch"], ec["image"], ec["image"], 3).astype(np.float32)
    t0 = time.perf_counter()
    save_inference_model(str(root / "resnet"), model, None, [x],
                         input_names=["image"])
    t1 = time.perf_counter()
    pred = InferencePredictor(str(root / "resnet"), device=device)
    t2 = time.perf_counter()
    got = torch.from_numpy(pred.run({"image": x})[0])
    with torch.no_grad():
        want = model(torch.from_numpy(x).to(device)).cpu()
    err = nn_cases.gap(got, want)
    check(err <= 1e-5, f"exported ResNet vs in-process: {err} > 1e-5")
    return {"layers": ec["resnet_layers"], "batch": ec["resnet_batch"],
            "image": ec["image"], "max_rel_err": err,
            "save_s": t1 - t0,
            "load_s": t2 - t1,
            "pt2_bytes": os.path.getsize(root / "resnet" / "model.pt2")}


def _flash_route_us(bc: dict, device: torch.device, calls: int = 100,
                    rounds: int = 5) -> Dict[str, float]:
    """Host us a call to enqueue kernel 4 at the exported BERT's shape
    (float32, segment ids), by three routes, interleaved over `rounds` of
    `calls` calls each, the median round: `flash_fwd` (the ctypes launch
    alone), `flash_fwd_op` (through the `torch.library` dispatcher) and
    `flash_attention` (the wrapper every model calls, through `FlashCore`
    and the operator), all under `no_grad`. Launch counts are reset by
    the caller's next counted run."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 85)
    b, t = bc["check_batch"], bc["seq"]
    h, d = bc["num_heads"], bc["model_dim"] // bc["num_heads"]
    q, k, v = (torch.randn(b, t, h, d, generator=g).to(device)
               for _ in range(3))
    seg = (torch.arange(t)[None, :] < torch.tensor(
        [t - 8 * i for i in range(b)])[:, None]).to(torch.int32).to(device)
    scale = 1.0 / d ** 0.5
    routes = {
        "flash_fwd": lambda: flash.flash_fwd(q, k, v, seg, seg, None,
                                             scale=scale),
        "flash_fwd_op": lambda: flash.flash_fwd_op(q, k, v, seg, seg, None,
                                                   scale, False, None, 0.0),
        "flash_attention": lambda: flash.flash_attention(
            q, k, v, scale, segment_ids=seg)}
    times: Dict[str, List[float]] = {name: [] for name in routes}
    with torch.no_grad():
        for fn in routes.values():
            fn()
        torch.cuda.synchronize(device)
        for _ in range(rounds):
            for name, fn in routes.items():
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                times[name].append((time.perf_counter() - t0) / calls * 1e6)
                torch.cuda.synchronize(device)
    return {name: float(np.median(ts)) for name, ts in times.items()}


def _export_bert(cfg: dict, device: torch.device, root: Path) -> dict:
    cuda = device.type == "cuda"
    bc = cfg["bert"]
    b = bc["check_batch"]
    model = _bert_model(bc, bc["num_layers"], torch.float32, device)
    tokens, _, lengths, _ = _bert_batch(dict(bc, batch=b), device,
                                        SEED + 83)
    entry = BertHidden(model)
    t0 = time.perf_counter()
    save_inference_model(str(root / "bert"), entry, None,
                         [tokens.cpu().numpy(), lengths.cpu().numpy()],
                         input_names=["tokens", "lengths"])
    t1 = time.perf_counter()
    pred = InferencePredictor(str(root / "bert"), device=device)
    t2 = time.perf_counter()
    graph = _graph_ops(pred.program)
    feed = {"tokens": tokens.cpu().numpy(), "lengths": lengths.cpu().numpy()}
    pred.run(feed)                      # warm-up, uncounted
    plain: Dict[str, float] = {}        # host ms of any plain call made
    with host_ms(plain, plain_flash=(flash, "flash_fwd_reference"),
                 plain_attention=(attention, "reference_attention")):
        _reset_launches()
        got = torch.from_numpy(pred.run(feed)[0])
        launches = _launches()
    with torch.no_grad():
        want = entry(tokens, lengths).cpu()
    err = nn_cases.gap(got, want)
    check(err <= 1e-5, f"exported BERT vs in-process: {err} > 1e-5")
    layers = bc["num_layers"]
    if cuda:
        check(graph["flash_fwd_op"] == layers and graph["softmax"] == 0,
              f"exported BERT graph: {graph}, want {layers} flash ops and "
              "no softmax")
        want_launches = dict.fromkeys(launches, 0)
        want_launches["flash_fwd"] = layers
        check(launches == want_launches,
              f"exported BERT launches {launches} != {want_launches}")
        check(not plain, f"exported BERT reached a plain version: "
                         f"{sorted(plain)}")
    return {"batch": b, "seq": bc["seq"], "layers": layers,
            "dtype": "float32", "save_s": t1 - t0, "load_s": t2 - t1,
            "graph_ops": graph,
            "flash_route_host_us": (_flash_route_us(bc, device) if cuda
                                    else None),
            "kernel_launches": launches,
            "plain_versions_called": sorted(plain),
            "max_rel_err": err,
            "pt2_bytes": os.path.getsize(root / "bert" / "model.pt2"),
            "feed": feed}


def _export_lm(cfg: dict, tree: dict, device: torch.device,
               root: Path) -> dict:
    ec = cfg["export"]
    model = load_jax_params(CausalLM(cfg["vocab"], **cfg["lm"],
                                     max_len=cfg["max_len"], device=device),
                            tree)
    t0 = time.perf_counter()
    save_inference_model(
        str(root / "lm"), model, None,
        [np.zeros((1, ec["lm_example"]), np.int32)], input_names=["tokens"],
        serve_meta=engine_mod.serve_metadata(model))
    t1 = time.perf_counter()
    rng = np.random.default_rng(SEED + 84)
    prompts = [rng.integers(1, cfg["vocab"], n).tolist()
               for n in ec["lm_prompts"]]
    saved = ServeEngine.from_saved_model(str(root / "lm"),
                                         **_engine_kw(cfg, device))
    got = saved.generate(prompts, max_new_tokens=ec["lm_new"])
    del saved
    t2 = time.perf_counter()
    mem = ServeEngine(model, **_engine_kw(cfg, device))
    want = mem.generate(prompts, max_new_tokens=ec["lm_new"])
    del mem
    t3 = time.perf_counter()
    check(got == want, "CausalLM export served by from_saved_model: "
                       "streams differ from the in-memory engine's")
    return {"prompts": len(prompts), "prompt_lens": ec["lm_prompts"],
            "new_tokens": ec["lm_new"], "dtype": "float32",
            "streams_equal": True, "save_s": t1 - t0,
            "from_saved_model_and_serve_s": t2 - t1,
            "in_memory_engine_and_serve_s": t3 - t2,
            "signature": json.load(open(root / "lm" / "signature.json"))}


def phase_export(cfg: dict, tree: dict, device: torch.device,
                 card: dict) -> dict:
    """io/inference on the card: (a) ResNet exported by
    `save_inference_model` and run by `InferencePredictor`, equal to the
    in-process module within 1e-5 of its largest logit; (b) BERT-base's
    forward (phase `bert`'s configuration, float32, with lengths),
    exported on the card: its graph holds kernel 4's operator once a
    layer and no softmax, and one predictor call launches kernel 4 once
    a layer and nothing reaches a plain version; (c) a CausalLM export
    at LM_BASE with `serve_meta`, served by `from_saved_model`, its
    greedy float32 streams equal to an engine over the same weights in
    memory. Between (b) and (c) the `cabi` phase serves (b)'s export
    through the C ABI (phase_cabi)."""
    root = EXPORT_DIR.parent / "chip_smoke_inference"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    tag = {"device": card["kind"], "nvidia_smi": card["smi"]}
    t_phase = time.perf_counter()
    try:
        out = {"resnet": _export_resnet(cfg["export"], device, root)}
        emit({"phase": "export", "part": "resnet", **out["resnet"], **tag})
        out["bert"] = _export_bert(cfg, device, root)
        feed = out["bert"].pop("feed")
        emit({"phase": "export", "part": "bert", **out["bert"], **tag})
        out["cabi"] = phase_cabi(cfg, root / "bert", feed,
                                 out["bert"]["layers"], device, card)
        out["lm"] = _export_lm(cfg, tree, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "export", "part": "lm", **out["lm"],
          "export_seconds": out["seconds"], **tag})
    return out


def phase_book(cfg: dict, device: torch.device, card: dict) -> dict:
    """The recognize-digits book chapter end to end
    (tests/test_book_mnist.py): LeNet on `datasets.mnist_train` (the
    seeded synthetic set), batches of 64 from `data.batch(data.shuffle(
    ..., buf_size=512, seed=0))` through `device_prefetch` onto the card,
    Adam 1e-3 for 3 epochs with a `CheckpointManager` save each epoch;
    test accuracy > 0.7; a restore into a new trainer gives the same eval
    loss; the export's predictor gives the module's logits; `freeze_int8`
    calibrated on two training batches keeps test accuracy > 0.7. The
    host ms a batch spent in the reader pipeline beside the step ms."""
    bk = cfg["book"]
    tag = {"device": card["kind"], "nvidia_smi": card["smi"]}
    t_phase = time.perf_counter()
    root = EXPORT_DIR.parent / "chip_smoke_book"
    shutil.rmtree(root, ignore_errors=True)
    train_reader = data.batch(data.shuffle(
        data.datasets.mnist_train(bk["train"]), buf_size=512, seed=0), 64)
    test_reader = data.batch(data.datasets.mnist_test(bk["test"]), 64)
    loss_fn = supervised_loss(softmax_with_cross_entropy,
                              metrics={"acc": accuracy})

    def build():
        model = LeNet(10, device=device)
        return Trainer(model, Adam(model.parameters(), 1e-3), loss_fn,
                       seed=0)
    torch.manual_seed(SEED + 85)
    trainer = build()
    mgr = CheckpointManager(str(root / "ckpts"), max_to_keep=2)
    losses, reader_ms, step_ms = [], [], []
    try:
        for _ in range(bk["epochs"]):
            batches = data.device_prefetch(train_reader(), size=2,
                                           device=device)
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                t1 = time.perf_counter()
                if batch is None:
                    break
                losses.append(float(trainer.train_step(batch)["loss"]))
                reader_ms.append((t1 - t0) * 1e3)
                step_ms.append((time.perf_counter() - t1) * 1e3)
            mgr.save(trainer.state(), step=trainer.step)
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        check(first > last * 1.5, f"book: no learning, first 10 {first}, "
                                  f"last 10 {last}")
        test = list(data.device_prefetch(test_reader(), device=device))

        def test_accuracy(model) -> float:
            right = n = 0
            with torch.no_grad():
                for x, y in test:
                    right += int((model(x).argmax(-1) == y).sum())
                    n += len(y)
            return right / n
        trainer.module.eval()
        acc = test_accuracy(trainer.module)
        check(acc > 0.7, f"book: test accuracy {acc} <= 0.7")
        restored = build()
        ts, step = mgr.restore_latest(target=restored.state())
        restored.load_state(ts)
        loss_a = float(trainer.eval_step(test[0])["loss"])
        loss_b = float(restored.eval_step(test[0])["loss"])
        check(step == trainer.step
              and abs(loss_a - loss_b) <= 1e-5 * abs(loss_a),
              f"book: restored step {step} loss {loss_b} != {loss_a}")
        x = test[0][0][:8].cpu().numpy()
        save_inference_model(str(root / "infer"), trainer.module, None, [x],
                             input_names=["image"])
        logits = InferencePredictor(str(root / "infer"),
                                    device=device).run({"image": x})[0]
        with torch.no_grad():
            want = trainer.module(test[0][0][:8]).cpu()
        export_err = nn_cases.gap(torch.from_numpy(logits), want)
        check(export_err <= 1e-4, f"book: export error {export_err}")
        calib = [b[0] for b in itertools.islice(
            data.device_prefetch(train_reader(), device=device), 2)]
        qmodel, _ = freeze_int8(copy.deepcopy(trainer.module), None, calib)
        acc8 = test_accuracy(qmodel)
        check(acc8 > 0.7, f"book: int8 test accuracy {acc8} <= 0.7")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"train": bk["train"], "test": bk["test"], "epochs": bk["epochs"],
           "steps": len(losses), "first_losses": losses[:3],
           "last_losses": losses[-3:], "test_accuracy": acc,
           "int8_test_accuracy": acc8, "restored_eval_loss": loss_b,
           "export_max_rel_err": export_err,
           "reader_ms_median": float(np.median(reader_ms)),
           "reader_ms_max": float(np.max(reader_ms)),
           "step_ms_median": float(np.median(step_ms)),
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "book", **out, **tag})
    return out


# -- training over a mesh of ranks -------------------------------------------

def _bench_line(what: str, r, launches: Dict[str, int], calls: int,
                card: dict) -> dict:
    """One BenchResult (unrounded) with the launches its run made, per
    step, beside the card's name and power limit; checked sane."""
    d = dataclasses.asdict(r)
    check(np.isfinite(r.value) and r.value > 0 and r.ms_per_step > 0,
          f"benchmark {what}: {d}")
    check(r.mfu is None or 0.0 < r.mfu < 1.0, f"benchmark {what}: MFU {d}")
    line = {"phase": "benchmark", "run": what, "result": d,
            "kernel_launches": launches, "calls": calls,
            "launches_per_call": {k: v / calls for k, v in launches.items()
                                  if v},
            "device": card["kind"], "nvidia_smi": card["smi"]}
    emit(line)
    return line


def phase_benchmark(cfg: dict, device: torch.device, card: dict) -> dict:
    """`paddle_tpu_torch.benchmark` on the card, through the entry points
    its CLI calls: `run_model("transformer")` (Transformer-base WMT,
    bf16, B 32 x T 256: kernels 4-6 in the encoder, the decoder's causal
    self-attention and the cross-attention), `run_model("lm_longctx")`
    (the LM at LM_BASE, bf16, B 1 x T 16384, fused CE: kernels 4-6), and
    `run_infer` on the CausalLM through a ServeEngine, over fp KV pools
    (kernel 1) and with the in-device int8 tier (kernel 2), each for a
    short timed window. Launch counts are set to 0 just before each run
    and read just after: a train spec's steps are its timed ones, the
    warm-up and the counted step (`bench_trainer`); each must launch
    its kernels once a layer a step (three attentions a layer for the
    Transformer) and no other kernel."""
    cuda = device.type == "cuda"
    bc = cfg["benchmark"]
    dev = "cuda" if cuda else "cpu"
    out = {}
    for what, (name, kw, per_step) in bc["train"].items():
        _reset_launches()
        r = bench.run_model(name, dtype=bc["dtype"], min_time=bc["min_time"],
                            device=dev, **kw)
        launches = _launches()
        calls = r.steps + 4                 # + 3 warm-up + the counted step
        want = dict.fromkeys(launches, 0)
        if cuda:
            want.update(dict.fromkeys(FLASH_KERNELS, calls * per_step))
        check(launches == want, f"benchmark {what}: launches {launches} "
                                f"!= {want} ({calls} steps)")
        out[what] = _bench_line(what, r, launches, calls, card)
    for what, (kernel, kw) in bc["infer"].items():
        _reset_launches()
        r = run_infer(what, dtype=bc["dtype"], min_time=bc["min_time"],
                      device=dev, **kw)
        launches = _launches()
        calls = r.steps + 3                 # + 3 warm-up waves
        layers = kw.get("num_layers", LM_BASE["num_layers"])
        others = {k: v for k, v in launches.items() if k != kernel}
        check(not any(others.values()) and (
            launches[kernel] > 0 and launches[kernel] % layers == 0
            if cuda else launches[kernel] == 0),
            f"benchmark {what}: launches {launches}")
        out[what] = _bench_line(what, r, launches, calls, card)
    launches = {k: sum(o["kernel_launches"][k] for o in out.values())
                for k in out[next(iter(out))]["kernel_launches"]}
    out["kernel_launches"] = launches
    return out


MESH_MODES = {"dp": "lm_dp", "fsdp": "lm_fsdp", "tp": "lm_tp"}
# f32 parity bars: tests/test_parallel.py:147-152 (dp, fsdp) and
# :223-228 (tp): (loss rtol, param rtol, param atol)
MESH_F32_BARS = {"dp": (2e-4, 1e-4, 1e-5), "fsdp": (2e-4, 1e-4, 1e-5),
                 "tp": (1e-3, 2e-3, 2e-4)}
# bf16 at full depth is held by its losses only: each step's loss within
# this relative gap of the single-rank run's (bf16's unit roundoff is
# 2^-8 = 3.9e-3; the ranks' bf16 GEMMs run at other batch shapes)
MESH_BF16_LOSS_RTOL = 2e-2
# ZeRO: a rank's parameter + Adam-slot bytes against the replicated run's
MESH_FSDP_BYTES_BAR = 0.55


def _mesh_ranks(cuda: bool, n: int):
    """(launch device, share_card, why) of an n-rank world."""
    if not cuda:
        return "cpu", False, "CPU rehearsal: every rank on the CPU over gloo"
    cards = torch.cuda.device_count()
    if cards >= n:
        return None, False, f"{cards} cards: each rank on its own card (nccl)"
    return (None, True,
            f"{cards} card: the {n} ranks share cuda:0 (launch --share-card),"
            " where NCCL refuses two ranks on one device, so the data plane"
            " is gloo through host memory; the NCCL path stays unrun on "
            "this machine")


def _median_ms(ms) -> float:
    ms = list(ms)
    return float(np.median(ms[1:] if len(ms) > 1 else ms))


def phase_mesh_train(cfg: dict, device: torch.device, card: dict) -> dict:
    """Training over a mesh of ranks (parallel/trainer.py's MeshTrainer)
    on the repo's LM, each rank a process of parallel/launch.py running
    the `lm_*` scenarios of paddle_tpu_torch/testing/mesh_cases.py:
    dp=2 (each rank B/2), fsdp=2 under REDUCE with fsdp_rules() (ZeRO:
    parameters, gradients and Adam slots sharded) and tp=2 under
    transformer_tp_rules (Megatron: kernels 4-6 at each rank's 4 heads).
    Each mode runs an f32 check at 2 layers of full width and the bf16
    run at full depth, both against a single-rank MeshTrainer in this
    process on the whole batch from the same weights. Then dp=2 x
    fsdp=2 on 4 ranks saves a sharded checkpoint (async) after 2 of 4
    steps, and a fresh world restores it and runs the last 2. Checks:
    the f32 bars (MESH_F32_BARS), the bf16 losses within
    MESH_BF16_LOSS_RTOL, kernels 4, 5 and 6 launched once a layer a step
    on every rank (counts set to 0 just before the steps), each fsdp
    rank's parameter + slot bytes at most MESH_FSDP_BYTES_BAR of the
    replicated rank's, and the restored run's losses and parameters
    equal to the straight run's bit for bit."""
    cuda = device.type == "cuda"
    mc = cfg["mesh_train"]
    conf = M.lm_conf(mc["vocab"], cfg["max_len"], cfg["lm"], SEED,
                     cfg["train_lr"], mc["runs"], save_step=mc["save_step"],
                     fsdp_min_size=mc["fsdp_min_size"])
    dev2, share2, why2 = _mesh_ranks(cuda, 2)
    dev4, share4, why4 = _mesh_ranks(cuda, 4)
    emit({"phase": "mesh_train", "part": "placement", "ranks_2": why2,
          "ranks_4": why4, "device": card["kind"],
          "nvidia_smi": card["smi"]})
    env = {"PTPU_LM": json.dumps(conf)}
    ref = {}
    for run in conf["runs"]:
        tr = M.lm_trainer(None, None, conf, run, device)
        ref[run["name"]] = M.lm_steps(tr, M.lm_batches(conf, run),
                                      run["name"])
        if run.get("params"):
            ref[run["name"]].update(M.pieces(tr.state().params,
                                             run["name"] + "/params"))
        del tr
        gc.collect()
    t0 = time.perf_counter()
    world = M.run_world(2, list(MESH_MODES.values()), device=dev2,
                        share_card=share2, env=env,
                        timeout=mc["world_timeout_s"])
    modes_s = time.perf_counter() - t0
    f32, big = conf["runs"][0], conf["runs"][-1]
    n_launch = big["steps"] * big["layers"]
    out = {"single": {"step_ms": ref[big["name"]][f"{big['name']}/step_ms"]
                      .tolist(),
                      "state_bytes": int(ref[big["name"]][
                          f"{big['name']}/state_bytes"])},
           "world_2_s": modes_s}
    replicated = None
    for mode, name in MESH_MODES.items():
        ranks = world[name]
        loss_rtol, p_rtol, p_atol = MESH_F32_BARS[mode]
        want = ref[f32["name"]]
        fname, bname = f32["name"], big["name"]
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(
                res[f"{fname}/losses"], want[f"{fname}/losses"],
                rtol=loss_rtol, err_msg=f"{mode} rank {r} f32 losses")
        got = M.join(ranks, f"{fname}/params")
        wantp = M.join([want], f"{fname}/params")
        p_gap = 0.0
        for path, w in wantp.items():
            np.testing.assert_allclose(got[path], w, rtol=p_rtol,
                                       atol=p_atol,
                                       err_msg=f"{mode} f32 {path}")
            p_gap = max(p_gap, float(np.abs(got[path] - w).max()))
        bl = ref[bname][f"{bname}/losses"]
        gaps = [float(np.max(np.abs(res[f"{bname}/losses"] - bl) / bl))
                for res in ranks]
        check(max(gaps) <= MESH_BF16_LOSS_RTOL,
              f"{mode}: bf16 losses {[res[f'{bname}/losses'].tolist() for res in ranks]} "
              f"vs single {bl.tolist()} (rel gap {max(gaps)} > "
              f"{MESH_BF16_LOSS_RTOL})")
        launches = []
        for r, res in enumerate(ranks):
            got_l = {k: int(res[f"{bname}/launches/{k}"])
                     for k in FLASH_KERNELS}
            want_l = dict.fromkeys(FLASH_KERNELS, n_launch if cuda else 0)
            check(got_l == want_l, f"{mode} rank {r}: launches {got_l} != "
                                   f"{want_l}")
            launches.append(got_l)
        held = [int(res[f"{bname}/state_bytes"]) for res in ranks]
        if mode == "dp":
            replicated = held[0]
        steps = big["steps"]
        rep = {"mode": mode, "ranks": len(ranks),
               "f32_losses": ranks[0][f"{fname}/losses"].tolist(),
               "f32_single_losses": want[f"{fname}/losses"].tolist(),
               "f32_param_max_abs_gap": p_gap,
               "f32_bars": {"loss_rtol": loss_rtol, "param_rtol": p_rtol,
                            "param_atol": p_atol},
               "bf16_losses": ranks[0][f"{bname}/losses"].tolist(),
               "bf16_single_losses": bl.tolist(),
               "bf16_loss_rel_gap": max(gaps),
               "bf16_loss_rtol": MESH_BF16_LOSS_RTOL,
               "step_ms_median": [_median_ms(res[f"{bname}/step_ms"])
                                  for res in ranks],
               "single_step_ms_median": _median_ms(
                   ref[bname][f"{bname}/step_ms"]),
               "collective_ms_per_step": [
                   float(res[f"{bname}/collective_s"]) * 1e3 / steps
                   for res in ranks],
               "collective_calls_per_step": [
                   int(res[f"{bname}/collective_calls"]) / steps
                   for res in ranks],
               "peak_bytes": [int(res[f"{bname}/peak_bytes"])
                              for res in ranks],
               "param_slot_bytes": held,
               "kernel_launches": launches, "layers": big["layers"],
               "steps": steps, "batch": big["batch"], "seq": big["seq"],
               "device": card["kind"], "nvidia_smi": card["smi"]}
        if mode == "fsdp":
            ratio = max(held) / replicated
            rep["bytes_vs_replicated"] = ratio
            check(ratio <= MESH_FSDP_BYTES_BAR,
                  f"fsdp: a rank holds {max(held)} bytes, {ratio:.3f} of "
                  f"the replicated {replicated}")
        emit({"phase": "mesh_train", **rep})
        out[mode] = rep
    ckdir = tempfile.mkdtemp(prefix="mesh_train_ckpt_")
    try:
        env4 = {**env, "PTPU_WORLD_CKPT": ckdir}
        t0 = time.perf_counter()
        straight = M.run_world(4, ["lm_zero_save"], device=dev4,
                               share_card=share4, env=env4,
                               timeout=mc["world_timeout_s"])["lm_zero_save"]
        resumed = M.run_world(4, ["lm_zero_resume"], device=dev4,
                              share_card=share4, env=env4,
                              timeout=mc["world_timeout_s"])[
                                  "lm_zero_resume"]
        zero_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    for r, (a, b) in enumerate(zip(straight, resumed)):
        check(int(b["step"]) == conf["save_step"],
              f"rank {r} resumed at {int(b['step'])}")
        check(np.array_equal(a["rest/losses"], b["rest/losses"]),
              f"rank {r}: resumed losses {b['rest/losses'].tolist()} != "
              f"straight {a['rest/losses'].tolist()}")
        keys = [k for k in a if k.startswith("params/")]
        check(keys and all(np.array_equal(a[k], b[k]) for k in keys),
              f"rank {r}: resumed parameters differ from the straight "
              "run's")
    zero = {"part": "zero_resume", "ranks": 4, "save_step": conf["save_step"],
            "straight_losses": np.concatenate(
                [straight[0]["first/losses"],
                 straight[0]["rest/losses"]]).tolist(),
            "resumed_losses": resumed[0]["rest/losses"].tolist(),
            "bit_equal": True, "worlds_s": zero_s,
            "step_ms_median": [_median_ms(x["rest/step_ms"])
                               for x in straight],
            "device": card["kind"], "nvidia_smi": card["smi"]}
    emit({"phase": "mesh_train", **zero})
    out["zero_resume"] = zero
    return out


# the bf16 kernel bar: 2e-2 of the largest magnitude (the flash
# phases' bf16 tolerance); f32 runs use the JAX tests' bars
PAR_BF16_BAR = 2e-2
# pipelines (f32): losses within 2e-4 relative of the dense steps', the
# parameters after Adam within 2e-3 (tests/test_pipeline.py:321-328),
# and the two schedules' losses within 1e-5 relative of each other
PAR_LOSS_RTOL, PAR_PARAM_ATOL, PAR_SCHEDULE_RTOL = 2e-4, 2e-3, 1e-5


def ring_launches(variant: str, rank: int, sp: int) -> int:
    """Kernel 4, 5 and 6 launches of one forward + backward on `rank`:
    contiguous causal skips the blocks of later ranks (r + 1 blocks),
    zig-zag runs three half-blocks at the first step and two after,
    non-causal every block, Ulysses one flash call."""
    return {"causal": rank + 1, "zigzag": 3 + 2 * (sp - 1), "full": sp,
            "ulysses": 1}[variant]


def phase_mesh_parallel(cfg: dict, device: torch.device, card: dict) -> dict:
    """The sp, pp and ep axes (parallel/ring.py, pipeline.py, moe.py)
    over ranks of parallel/launch.py running the `chip_*` cases of
    paddle_tpu_torch/testing/parallel_cases.py, in one 2-rank world
    (sp=2, then pp=2, then ep=2) and one 4-rank world (pp=2 x ep=2):

    - (a) ring flash (causal contiguous and zig-zag, non-causal) and
      Ulysses at cfg's long-context shape: each rank's o, dq, dk and dv
      within the bar of plain float32 attention on the whole sequence,
      computed on the card (the gap to one rank's `flash_attention` on
      it printed beside); kernels 4, 5 and 6 launched as
      `ring_launches` says on each rank (counts set to 0 just before);
    - (b) PipelinedLM on pp=2 under GPipe and 1F1B: the Adam steps'
      losses within PAR_LOSS_RTOL of one rank's dense steps here, every
      parameter after them within PAR_PARAM_ATOL, the two schedules'
      losses within PAR_SCHEDULE_RTOL, and on the card 1F1B's peak
      below GPipe's;
    - (c) moe_ffn and moe_ffn_a2a on ep=2 against one rank's moe_ffn:
      y and the gate's gradient within the bar (a2a where nothing was
      dropped), a2a against masked at ample capacity, the dropped
      fraction falling as the capacity grows; PipelinedMoELM on
      pp=2 x ep=2 (capacity ample, no balance loss): every step's loss
      within PAR_LOSS_RTOL of one rank's dense Adam steps here, every
      parameter after them within PAR_PARAM_ATOL.

    Ranks sharing one card time-slice it and stage every collective
    through host memory: their ms measure that, not scaling."""
    cuda = device.type == "cuda"
    pc = cfg["mesh_parallel"]
    dev2, share2, why2 = _mesh_ranks(cuda, 2)
    dev4, share4, why4 = _mesh_ranks(cuda, 4)
    emit({"phase": "mesh_parallel", "part": "placement", "ranks_2": why2,
          "ranks_4": why4, "device": card["kind"],
          "nvidia_smi": card["smi"]})
    tmp = tempfile.mkdtemp(prefix="mesh_parallel_")
    try:
        t0 = time.perf_counter()
        ref_path = os.path.join(tmp, "dense.pt")
        moe_ref_path = os.path.join(tmp, "dense_moe.pt")
        dense_losses, final = PC.dense_pipe_steps(pc["pipe"], device)
        torch.save({k: v.cpu() for k, v in final.items()}, ref_path)
        moe_losses, final = PC.dense_pipe_steps(pc["moe_lm"], device,
                                                moe=True)
        torch.save({k: v.cpu() for k, v in final.items()}, moe_ref_path)
        del final
        gc.collect()
        dense_s = time.perf_counter() - t0
        env = {"PTPU_PAR": json.dumps(PC.par_conf(
            pc["ring"], pc["pipe"], pc["moe"], pc["moe_lm"], ref_path,
            moe_ref_path))}
        t0 = time.perf_counter()
        world = PC.run_world(2, ["chip_ring", "chip_pipe", "chip_moe"],
                             device=dev2, share_card=share2, env=env,
                             timeout=pc["world_timeout_s"])
        world_2_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        moe_lm = PC.run_world(4, ["chip_moe_lm"], device=dev4,
                              share_card=share4, env=env,
                              timeout=pc["world_timeout_s"])["chip_moe_lm"]
        world_4_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    info = {"device": card["kind"], "nvidia_smi": card["smi"]}
    out = {"world_2_s": world_2_s, "world_4_s": world_4_s,
           "dense_pipe_s": dense_s}

    # (a) long context
    rc = pc["ring"]
    sp = 2
    launches = {}
    for variant in PC.RING_VARIANTS:
        ranks = world["chip_ring"]
        rows = []
        for r, res in enumerate(ranks):
            got = [int(x) for x in res[f"{variant}/launches"]]
            want = [ring_launches(variant, r, sp) if cuda else 0] * 3
            check(got == want, f"mesh_parallel {variant} rank {r}: kernel "
                               f"4/5/6 launches {got} != {want}")
            errs = {n: float(res[f"{variant}/err_{n}"])
                    for n in ("o", "dq", "dk", "dv")}
            check(max(errs.values()) <= rc["bar"],
                  f"mesh_parallel {variant} rank {r}: {errs} over "
                  f"{rc['bar']} of the largest magnitude of plain f32 "
                  f"attention")
            rows.append({"rank": r, "launches": dict(zip(FLASH_KERNELS,
                                                         got)),
                         "errors_vs_plain_f32": errs,
                         "errors_vs_whole_flash": {
                             n: float(res[f"{variant}/err_flash_{n}"])
                             for n in ("o", "dq", "dk", "dv")},
                         "fwd_ms": float(res[f"{variant}/fwd_ms"]),
                         "bwd_ms": float(res[f"{variant}/fwd_bwd_ms"])
                         - float(res[f"{variant}/fwd_ms"]),
                         "collective_calls": int(
                             res[f"{variant}/collective_calls"]),
                         "collective_s": float(
                             res[f"{variant}/collective_s"]),
                         "peak_bytes": int(res[f"{variant}/peak_bytes"])})
        launches[variant] = [dict(zip(FLASH_KERNELS,
                                      [int(x) for x in res[
                                          f"{variant}/launches"]]))
                             for res in ranks]
        rep = {"phase": "mesh_parallel", "part": "long_context",
               "variant": variant, "shape": rc["shape"],
               "dtype": rc["dtype"], "sp": sp, "bar": rc["bar"],
               "ranks": rows, **info}
        emit(rep)
        out[variant] = rep
    out["kernel_launches"] = launches

    # (b) the pipeline
    pcf = pc["pipe"]
    sched = {}
    for schedule in ("gpipe", "1f1b"):
        ranks = world["chip_pipe"]
        losses = ranks[0][f"{schedule}/losses"]
        for r, res in enumerate(ranks):
            gap = float(np.max(np.abs(res[f"{schedule}/losses"]
                                      - dense_losses)
                               / np.abs(dense_losses)))
            check(gap <= PAR_LOSS_RTOL,
                  f"mesh_parallel {schedule} rank {r}: losses "
                  f"{res[f'{schedule}/losses'].tolist()} vs dense "
                  f"{dense_losses} (rel {gap})")
            pgap = float(res[f"{schedule}/param_gap"])
            check(pgap <= PAR_PARAM_ATOL,
                  f"mesh_parallel {schedule} rank {r}: parameters "
                  f"{pgap} from the dense steps'")
        sched[schedule] = {
            "losses": losses.tolist(),
            "step_ms_median": [_median_ms(res[f"{schedule}/step_ms"])
                               for res in ranks],
            "peak_bytes": [int(res[f"{schedule}/peak_bytes"])
                           for res in ranks],
            "collective_calls_per_step": [
                int(res[f"{schedule}/collective_calls"]) / pcf["steps"]
                for res in ranks],
            "collective_ms_per_step": [
                float(res[f"{schedule}/collective_s"]) * 1e3 / pcf["steps"]
                for res in ranks],
            "param_gap": [float(res[f"{schedule}/param_gap"])
                          for res in ranks]}
    a, b = (np.asarray(sched[s]["losses"]) for s in ("gpipe", "1f1b"))
    check(float(np.max(np.abs(a - b) / np.abs(a))) <= PAR_SCHEDULE_RTOL,
          f"mesh_parallel: 1f1b losses {b.tolist()} vs gpipe {a.tolist()}")
    if cuda:
        check(max(sched["1f1b"]["peak_bytes"])
              < max(sched["gpipe"]["peak_bytes"]),
              f"mesh_parallel: 1f1b peak {sched['1f1b']['peak_bytes']} not "
              f"below gpipe's {sched['gpipe']['peak_bytes']}")
    rep = {"phase": "mesh_parallel", "part": "pipeline", "pp": 2,
           "stages": pcf["stages"], "microbatches": pcf["m"],
           "batch": pcf["batch"], "seq": pcf["seq"], "steps": pcf["steps"],
           "dense_losses": dense_losses, **sched, **info}
    emit(rep)
    out["pipeline"] = rep

    # (c) experts
    mc = pc["moe"]
    ranks = world["chip_moe"]
    runs = ["masked"] + [f"a2a_cf{cf}" for cf in mc["cfs"]]
    moe_rows = {}
    for name in runs:
        dropped = float(ranks[0][f"{name}/dropped"])
        errs = [{"y": float(res[f"{name}/err_y"]),
                 "gate": float(res[f"{name}/err_gate"])} for res in ranks]
        if dropped == 0.0:
            check(max(max(e.values()) for e in errs) <= mc["bar"],
                  f"mesh_parallel moe {name}: {errs} over {mc['bar']}")
        moe_rows[name] = {"dropped_fraction": dropped, "errors": errs,
                          "ms": [float(res[f"{name}/ms"]) for res in ranks]}
    drops = [moe_rows[f"a2a_cf{cf}"]["dropped_fraction"] for cf in mc["cfs"]]
    check(drops == sorted(drops, reverse=True) and drops[-1] == 0.0,
          f"mesh_parallel moe: dropped fractions {drops} over capacity "
          f"factors {mc['cfs']}")
    a2a_gap = max(float(res["a2a_vs_masked"]) for res in ranks)
    check(a2a_gap <= mc["bar"], f"mesh_parallel moe: a2a vs masked "
                                f"{a2a_gap} at ample capacity")
    ml = pc["moe_lm"]
    for r, res in enumerate(moe_lm):
        gap = float(np.max(np.abs(res["losses"] - moe_losses)
                           / np.abs(moe_losses)))
        check(gap <= PAR_LOSS_RTOL,
              f"mesh_parallel moe_lm rank {r}: losses "
              f"{res['losses'].tolist()} vs dense {moe_losses} (rel {gap})")
        check(float(res["param_gap"]) <= PAR_PARAM_ATOL,
              f"mesh_parallel moe_lm rank {r}: parameters "
              f"{float(res['param_gap'])} from the dense steps'")
    rep = {"phase": "mesh_parallel", "part": "experts", "ep": 2,
           "shape": {k: mc[k] for k in ("experts", "d", "hid", "tokens",
                                        "k", "dtype")},
           "runs": moe_rows, "a2a_vs_masked": a2a_gap,
           "moe_lm": {"mesh": "pp=2 x ep=2", "experts": ml["experts"],
                      "losses": moe_lm[0]["losses"].tolist(),
                      "dense_losses": moe_losses,
                      "param_gap": [float(res["param_gap"])
                                    for res in moe_lm],
                      "step_ms_median": [_median_ms(res["step_ms"])
                                         for res in moe_lm]},
           **info}
    emit(rep)
    out["experts"] = rep
    emit({"phase": "mesh_parallel", "part": "seconds",
          "dense_pipe_s": dense_s, "world_2_s": world_2_s,
          "world_4_s": world_4_s})
    return out


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
        # files: the train phase's model and B x T from two slot files of
        # 24 rows (12 steps), first tokens from [0, 64); RecordIO round
        # trips of 4096 records
        files=dict(files=2, rows=24, window=64, records=4096),
        # profile: 3 more train steps under the port's profiler, the top
        # 8 rows of its op table; a 256-token prompt, 8 new tokens
        profile_steps=3, profile_top=8, profile_prompt=256, profile_new=8,
        # selfcheck: flash_selfcheck()'s defaults (JAX's)
        selfcheck=dict(),
        # cabi: timed calls, 4 clones x 10 calls against 40 serial ones
        cabi=dict(calls=20, clones=4, clone_calls=10, timeout_s=300),
        # generate: B 8 at two prompt lengths, 64 new tokens each;
        # prefill_paged over 8 prompts of 300-512 right-padded
        gen=dict(batch=8, lens=(300, 512), new=64,
                 paged_lens=[300 + 30 * i for i in range(7)] + [512]),
        # resume: the train phase's batch, bf16 Adam, saved after 3 of 6
        resume=dict(steps=6, split=3, batch=4),
        # resilient: the train path's B x T, 6 steps, saves every 2, a
        # bad-step budget of 2, a first step held 0.6 s past a 0.2 s
        # watchdog
        resilient=dict(steps=6, batch=4, save_every=2, budget=2,
                       watchdog_s=0.2, stall_s=0.6),
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
                  bytes=256 << 20, compress_blocks=32, filler_waves=2),
        # engine_tp: tp=2 over the engine phase's traffic and engine_int8's
        tp=dict(size=2),
        # serve_http: 16 greedy completions of 32 tokens through the
        # router, 8 on a 256-token prefix with suffixes of 16-1200 (to the
        # prefill replica) and 8 of 20-60 tokens (to the decode replica);
        # a client that leaves after 4 of 256 tokens; a 272-token request
        # on the prefix for 160 tokens (decode-heavy: the decode replica
        # pulls the prefix); a 1 GB host tier on each replica
        serve_http=dict(prefix=256, suffix=(16, 1200), short=(20, 60),
                        requests=16, new=32, gone_new=256, xfer_new=160,
                        tier_bytes=1 << 30, latency_pairs=16),
        # bert: BERT-base MLM at paddle_tpu/benchmark/models.py:_bert's
        # widths and batch; 8 steps; lengths 64-128 leave padding; the f32
        # check at 2 layers on 8 rows
        bert=dict(vocab=30522, model_dim=768, num_heads=12, num_layers=12,
                  ffn_dim=3072, seq=128, max_len=128, masked=19, batch=32,
                  lengths=(64, 128), steps=8, lr=1e-4, check_batch=8),
        # seq2seq: Transformer-base WMT at models.py:_transformer's widths,
        # batch 16, 6 steps, source lengths 128-256; decoding on 4 sources,
        # beam 4 over 32 tokens, greedy 32 tokens, block 16; the f32 check
        # at 2 + 2 layers on 4 rows
        seq2seq=dict(vocab=32000, model_dim=512, num_heads=8, num_layers=6,
                     ffn_dim=2048, seq=256, max_len=257, batch=16,
                     lengths=(128, 256), steps=6, lr=1e-4, sources=4,
                     beam=4, decode=32, block_size=16, check_batch=4),
        # ops_sweep: SSD300 (Liu et al. 2016; the Caffe SSD VOC
        # deploy.prototxt): six prior layers, 8,732 priors, 21 classes
        # with background 0, confidence 0.01, NMS 0.45, top_k 400,
        # keep_top_k 200; CTC over DeepSpeech2's English alphabet
        # (Amodei et al. 2016: 28 symbols + blank 0), B 32 x T 400 frames,
        # labels of 20-80 symbols
        ssd=dict(image=300, maps=(38, 19, 10, 5, 3, 1),
                 steps=(8, 16, 32, 64, 100, 300),
                 min_sizes=(30, 60, 111, 162, 213, 264),
                 max_sizes=(60, 111, 162, 213, 264, 315),
                 ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
                 classes=21, score_threshold=0.01, nms_threshold=0.45,
                 nms_top_k=400, keep_top_k=200, priors=8732),
        ctc=dict(batch=32, frames=400, symbols=29, labels=(20, 80)),
        op_iters=5,
        # zoo: paddle_tpu/benchmark/models.py's resnet50 (224x224x3, 1000
        # classes, B 64, Momentum 0.1 / 0.9, bf16) and stacked_lstm
        # (vocab 10000, embed 128, hidden 512, 2 layers, B 64 x T 100,
        # Adam 1e-3, f32) specs; the card-vs-CPU step at 64x64, B 8
        zoo=dict(step=dict(layers=(1, 1, 1, 1), image=64, batch=8,
                           classes=10),
                 resnet=dict(layers=(3, 4, 6, 3), image=224, batch=64,
                             classes=1000, dtype=torch.bfloat16, warmup=2,
                             steps=8),
                 lstm=dict(vocab=10000, embed=128, hidden=512, layers=2,
                           batch=64, seq=100, steps=5)),
        # quant: bench.py's _int8_compute_bench (resnet50, 1000 classes,
        # 224x224x3, B 16 and 128, one calibration batch); the LM head at
        # int8_compute.py's docstring shape [4096, 512] x [512, 32000]
        quant=dict(layers=(3, 4, 6, 3), classes=1000, image=224,
                   batches=(16, 128), iters=5, head=(4096, 512, 32000)),
        # export: ResNet-50 at B 16 f32; BERT at the bert phase's widths,
        # B 8 x T 128; the LM at LM_BASE, four prompts, 16 new tokens
        export=dict(resnet_layers=(3, 4, 6, 3), classes=1000, image=224,
                    resnet_batch=16, lm_example=16,
                    lm_prompts=(40, 100, 7, 64), lm_new=16),
        # book: tests/test_book_mnist.py's LeNet run
        book=dict(train=2048, test=512, epochs=3),
        # benchmark: paddle_tpu_torch.benchmark's specs at their defaults
        # (models.py: transformer B 32 x T 256, lm_longctx B 1 x T
        # 16384; causal_lm waves of 16 prompts of 128 + 32 new tokens) in
        # bf16, a 1 s window each; (spec, its keywords, flash launches a
        # step: a layer's attentions)
        benchmark=dict(
            dtype=torch.bfloat16, min_time=1.0,
            train={"transformer": ("transformer", {}, 3 * 6),
                   "lm_longctx": ("lm_longctx", {}, LM_BASE["num_layers"])},
            infer={"causal_lm": ("ragged_paged_attention", {}),
                   "causal_lm_int8kv": ("ragged_paged_attention_mixed",
                                        {})}),
        # mesh_train: the LM at full width, f32 at 2 layers (B 4 x T 256,
        # 3 SGD steps, as tests/test_parallel.py's parity bar) and bf16 at
        # full depth (phase train's B 4 x T 2048, 4 Adam steps);
        # fsdp_rules()'s default min_size
        mesh_train=dict(
            vocab=LM_VOCAB, save_step=2, fsdp_min_size=1 << 16,
            world_timeout_s=400,
            runs=[dict(name="f32", dtype="float32", layers=2, batch=4,
                       seq=256, steps=3, params=True, optimizer="sgd",
                       lr=0.05),
                  dict(name="bf16", dtype="bfloat16",
                       layers=LM_BASE["num_layers"], batch=4, seq=2048,
                       steps=4)]),
        # mesh_parallel: (a) the lm_longctx widths (models.py:150-156,
        # LM_BASE: 8 heads of 64) at B 1 x T 16384, bf16; (b) PipelinedLM
        # at LM_BASE's widths, 6 stages, f32, B 8 x T 1024, 4
        # microbatches, 3 Adam steps; (c) bench.py:249's MoE shape, and a
        # PipelinedMoELM with 4 experts a stage, B 4 x T 1024, 2 steps
        # (top-2 of 4 at the default capacity factor 2.0: a capacity of
        # every token, so nothing drops and the dense steps are exact)
        mesh_parallel=dict(
            world_timeout_s=600,
            ring=dict(shape=[1, 16384, 8, 64], dtype="bfloat16", seed=SEED,
                      iters=3, bar=PAR_BF16_BAR),
            pipe=dict(vocab=LM_VOCAB, d_model=512, n_heads=8, d_ff=2048,
                      stages=6, max_len=LM_MAX_LEN, batch=8, seq=1024, m=4,
                      steps=3, lr=1e-4, seed=SEED),
            moe=dict(experts=8, d=1024, hid=4096, tokens=8192,
                     dtype="bfloat16", k=2, cfs=[1.0, 1.25, 2.0, 4.0],
                     iters=3, bar=PAR_BF16_BAR, seed=SEED),
            moe_lm=dict(vocab=LM_VOCAB, d_model=512, n_heads=8, d_ff=2048,
                        stages=6, max_len=LM_MAX_LEN, experts=4, batch=4,
                        seq=1024, m=4, steps=2, lr=1e-4, seed=SEED)))


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
        files=dict(files=2, rows=16, window=32, records=256),
        profile_steps=3, profile_top=8, profile_prompt=12, profile_new=3,
        selfcheck=dict(batch=1, heads=2, seq=128, head_dim=32,
                       dtype=torch.float32, atol=1e-3),
        cabi=dict(calls=3, clones=4, clone_calls=3, timeout_s=300),
        gen=dict(batch=2, lens=(12, 20), new=6, paged_lens=[12, 16, 20]),
        resume=dict(steps=4, split=2, batch=2),
        resilient=dict(steps=6, batch=2, save_every=2, budget=2,
                       watchdog_s=0.2, stall_s=0.6),
        optim_shapes=[(4, 4), (6,)],
        spec=dict(k=4, span=12, prompt=40, new=8, groups=2, n=2,
                  eager_new=4),
        tier=dict(prompt=40, new=20, num_blocks=14, roomy_blocks=64,
                  bytes=16 << 20, compress_blocks=4, filler_waves=2),
        tp=dict(size=2),
        serve_http=dict(prefix=32, suffix=(4, 60), short=(5, 10),
                        requests=8, new=6, gone_new=40, xfer_new=30,
                        tier_bytes=16 << 20, latency_pairs=2),
        bert=dict(vocab=97, model_dim=64, num_heads=8, num_layers=2,
                  ffn_dim=128, seq=32, max_len=32, masked=4, batch=4,
                  lengths=(16, 32), steps=8, lr=1e-3, check_batch=2),
        seq2seq=dict(vocab=97, model_dim=64, num_heads=8, num_layers=2,
                     ffn_dim=128, seq=24, max_len=25, batch=4,
                     lengths=(12, 24), steps=6, lr=1e-3, sources=4,
                     beam=4, decode=8, block_size=4, check_batch=2),
        ssd=dict(image=300, maps=(5, 3, 1), steps=(60, 100, 300),
                 min_sizes=(60, 162, 264), max_sizes=(111, 213, 315),
                 ratios=((2,), (2, 3), (2,)), classes=5,
                 score_threshold=0.01, nms_threshold=0.45, nms_top_k=16,
                 keep_top_k=10, priors=158),
        ctc=dict(batch=4, frames=24, symbols=29, labels=(3, 8)),
        op_iters=2,
        zoo=dict(step=dict(layers=(1, 1, 1, 1), image=32, batch=2,
                           classes=10),
                 resnet=dict(layers=(1, 1, 1, 1), image=32, batch=2,
                             classes=10, dtype=torch.float32, warmup=1,
                             steps=2),
                 lstm=dict(vocab=50, embed=8, hidden=16, layers=2, batch=2,
                           seq=8, steps=2)),
        quant=dict(layers=(1, 1, 1, 1), classes=10, image=32,
                   batches=(4, 8), iters=2, head=(32, 16, 96)),
        export=dict(resnet_layers=(1, 1, 1, 1), classes=10, image=32,
                    resnet_batch=2, lm_example=8, lm_prompts=(5, 9),
                    lm_new=4),
        book=dict(train=2048, test=512, epochs=3),
        benchmark=dict(
            dtype=torch.float32, min_time=0.01,
            train={"transformer": ("transformer", dict(
                       batch_size=2, seq_len=8, vocab=97, model_dim=32,
                       num_heads=4, num_layers=2, ffn_dim=64), 3 * 2),
                   "lm_longctx": ("lm_longctx", dict(
                       seq_len=32, vocab=97, model_dim=32, num_heads=4,
                       num_layers=2, ffn_dim=64), 2)},
            infer={name: (kernel, dict(
                       batch_size=2, vocab=61, model_dim=32, num_heads=4,
                       num_layers=2, ffn_dim=64, max_len=16, prompt=6,
                       new=3))
                   for name, kernel in (
                       ("causal_lm", "ragged_paged_attention"),
                       ("causal_lm_int8kv",
                        "ragged_paged_attention_mixed"))}),
        # the vocab a multiple of 4 (the tp and fsdp rows split evenly);
        # a min_size the tiny weights reach
        mesh_train=dict(
            vocab=96, save_step=1, fsdp_min_size=1024, world_timeout_s=240,
            runs=[dict(name="f32", dtype="float32", layers=2, batch=4,
                       seq=16, steps=2, params=True, optimizer="sgd",
                       lr=0.05),
                  dict(name="big", dtype="float32", layers=2, batch=4,
                       seq=32, steps=2)]),
        mesh_parallel=dict(
            world_timeout_s=240,
            ring=dict(shape=[1, 64, 2, 16], dtype="float32", seed=SEED,
                      iters=1, bar=1e-4),
            pipe=dict(vocab=96, d_model=32, n_heads=4, d_ff=64, stages=2,
                      max_len=64, batch=4, seq=16, m=2, steps=2, lr=1e-3,
                      seed=SEED),
            moe=dict(experts=4, d=16, hid=32, tokens=64, dtype="float32",
                     k=2, cfs=[1.0, 1.25, 2.0], iters=1, bar=1e-4,
                     seed=SEED),
            moe_lm=dict(vocab=96, d_model=32, n_heads=4, d_ff=64, stages=2,
                        max_len=64, experts=4, batch=4, seq=16, m=2,
                        steps=2, lr=1e-3, seed=SEED)))


@contextlib.contextmanager
def quiet_streams(*streams):
    """Silence the port's event streams `streams` on stdout; restore."""
    loggers = [logging.getLogger(f"paddle_tpu_torch.{s}") for s in streams]
    old = [lg.disabled for lg in loggers]
    for lg in loggers:
        lg.disabled = True
    try:
        yield
    finally:
        for lg, was in zip(loggers, old):
            lg.disabled = was


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if cuda else "cpu")
    cfg = full_config() if cuda else tiny_config()
    torch.manual_seed(SEED)

    # the event streams print a JSON line per event (the serve stream one
    # a step); keep stdout to phases (the phases read events by taps). The
    # rehearsal runs on one CPU thread: beside other processes (a parallel
    # test run) torch's pool of a thread a core oversubscribes the host
    threads = contextlib.nullcontext() if cuda else one_torch_thread()
    with quiet_streams("serve", "resilience", "obs"), threads:
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
        paths = {"ragged_paged_attention": phase_engine(cfg, tree, device,
                                                        card),
                 "ragged_paged_attention_mixed": phase_engine_int8(
                     cfg, tree, device, card)}
        spec = phase_engine_spec(cfg, tree, device, card)
        phase_engine_tier(cfg, tree, device, card)
        serve_http = phase_serve_http(cfg, tree, device, card)
        tp = phase_engine_tp(cfg, tree, device, card)
        paths["paged_attention"] = phase_split_path(cfg, tree, device, card)
        train, trainer, batch = phase_train(cfg, tree, device, card)
        paths.update(dict.fromkeys(FLASH_KERNELS, train))
        prof = phase_profile(cfg, tree, trainer, batch,
                             train["step_ms_median"], device, card)
        del trainer, batch
        selfcheck = phase_selfcheck(cfg, device, card)
        phase_train_vs_plain(cfg, tree, device)
        files = phase_files(cfg, tree, device, card, train["step_ms_median"])
        generate = phase_generate(cfg, tree, device, card)
        phase_resume(cfg, tree, device, card)
        phase_resilient(cfg, tree, device, card)
        phase_optimizers(cfg, device)
        bert = phase_bert(cfg, device, card)
        seq2seq = phase_seq2seq(cfg, device, card)
        phase_ops_sweep(cfg, device, card)
        phase_zoo(cfg, device, card)
        phase_quant(cfg, device, card)
        export = phase_export(cfg, tree, device, card)
        phase_book(cfg, device, card)
        benchmark = phase_benchmark(cfg, device, card)
        mesh = phase_mesh_train(cfg, device, card)
        par = phase_mesh_parallel(cfg, device, card)

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
                rows[-1]["launches_serve_http"] = \
                    serve_http["kernel_launches"][name]
                rows[-1]["launches_tp_per_rank"] = {
                    mode: [r[name] for r in tp[mode]["rank_launches"]]
                    for mode in ("fp", "int8")}
            if name == "ragged_paged_attention_mixed":
                rows[-1]["launches_tp_per_rank"] = [
                    r[name] for r in tp["int8_tier"]["rank_launches"]]
            if name == "flash_fwd":
                rows[-1]["launches_export"] = \
                    export["bert"]["kernel_launches"][name]
                rows[-1]["launches_cabi"] = \
                    export["cabi"]["kernel_launches"][name]
                rows[-1]["launches_generate"] = {
                    dt: r["kernel_launches"][name]
                    for dt, r in generate.items()}
            if name in FLASH_KERNELS or name.startswith("ragged"):
                rows[-1]["launches_benchmark"] = \
                    benchmark["kernel_launches"][name]
            if name in FLASH_KERNELS:
                rows[-1]["launches_mesh_tp_per_rank"] = [
                    r[name] for r in mesh["tp"]["kernel_launches"]]
                rows[-1]["launches_mesh_parallel_per_rank"] = {
                    v: [r[name] for r in ranks]
                    for v, ranks in par["kernel_launches"].items()}
                rows[-1]["launches_bert"] = bert["kernel_launches"][name]
                rows[-1]["launches_files"] = files["kernel_launches"][name]
                rows[-1]["launches_profile"] = prof["kernel_launches"][name]
                rows[-1]["launches_selfcheck"] = \
                    selfcheck["kernel_launches"][name]
                rows[-1]["launches_seq2seq"] = \
                    seq2seq["kernel_launches"][name]
            if name == "paged_attention":
                rows[-1]["launches_seq2seq"] = \
                    seq2seq["paged_kernel_launches"][name]
        emit({"kernels": rows})
        if cuda:
            emit({"ok": True, "device": {"platform": "gpu",
                                         "kind": card["kind"],
                                         "count": card["count"]}})
        else:
            emit({"ok": True, "rehearsal": True,
                  "device": {"platform": "cpu", "kind": "cpu", "count": 0}})
        return 0


if __name__ == "__main__":
    sys.exit(main())
