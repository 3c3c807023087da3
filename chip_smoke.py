#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # on the machine with the card
    python3 chip_smoke.py --tiny     # rehearsal on the CPU, plain versions

Builds every CUDA kernel of the serving path from the sources in this
checkout, holds each kernel against its plain PyTorch version at the
path's shapes, times it, and then drives the port's main path — a
`ServeEngine` over the repo's LM configuration (LM_BASE/LM_VOCAB of
paddle_tpu/benchmark/models.py: vocab 32000, d 512, 8 heads, 6 layers,
ffn 2048, tied head, max_len 2048, bf16) with random weights made from
a seed — through the entry points a user calls. Each phase prints one
JSON line; any failed check raises and the script exits non-zero. The
last line is `{"ok": true, "device": {...}}`.

Without a CUDA card (and without --tiny) it exits non-zero and prints
no result. Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import subprocess
import sys
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.engine import ServeEngine
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.testing import (RAGGED_ARGS, STEP_ARGS, causal_lm_tree,
                                      pack_prompts, ragged_case)

# the repo's LM configuration (paddle_tpu/benchmark/models.py:150-152)
LM_BASE = dict(model_dim=512, num_heads=8, num_layers=6, ffn_dim=2048,
               dropout=0.0)
LM_VOCAB = 32000
LM_MAX_LEN = 2048

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

SEED = 1234


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# -- operands -----------------------------------------------------------

def ragged_args(rows: Sequence[Tuple[int, int]], h: int, hkv: int, d: int,
                bs: int, tq: int, num_blocks: int, mb: int, pad_tiles: int,
                dtype: torch.dtype, device: torch.device,
                seed: int) -> List[torch.Tensor]:
    """ragged_paged_attention's operands on `device` (testing.ragged_case:
    (context_len, q_len) rows, shuffled block ids, the null row behind
    the pad tiles); q and pools in `dtype`."""
    case = ragged_case(rows, h, hkv, d, bs, tq, num_blocks, mb, pad_tiles,
                       seed)
    return [torch.from_numpy(case[k]).to(device=device, dtype=dtype)
            if case[k].dtype == np.float32
            else torch.from_numpy(case[k]).to(device) for k in RAGGED_ARGS]


def step_cost(args, scale_bytes: int) -> Tuple[float, float]:
    """(bytes, FLOPs) a ragged step must at least move and do on these
    inputs: q read and out written once, every K/V block some row
    needs read once, the int32 metadata; 4*D FLOPs per (query head,
    visible kv position)."""
    q, k_pool, _, bt, cl, qs, tr, to = [a.cpu() for a in args]
    t, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    tq = t // tr.shape[0]
    blocks = set()
    for row in range(bt.shape[0]):
        nblk = -(-int(cl[row]) // bs)
        blocks.update(bt[row, :nblk].tolist())
    kv_bytes = 2 * len(blocks) * bs * hkv * d * scale_bytes
    meta = sum(a.numel() * 4 for a in (bt, cl, qs, tr, to))
    nbytes = 2 * t * h * d * scale_bytes + kv_bytes + meta
    flops = 0
    for tile in range(tr.shape[0]):
        row = int(tr[tile])
        q0 = int(qs[row]) + int(to[tile])
        for i in range(tq):
            flops += 4 * h * d * min(q0 + i + 1, int(cl[row]))
    return float(nbytes), float(flops)


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
    dynamic shared memory a CTA takes at the serving path's shape."""
    if not cuda:
        emit({"phase": "build", "skipped": "no nvcc in a CPU rehearsal"})
        return
    t0 = time.perf_counter()
    infos = build.build_all()
    seconds = time.perf_counter() - t0
    smem = paged.shared_memory_bytes(cfg["tile_q"], 1, cfg["head_dim"],
                                     cfg["block_size"])
    emit({"phase": "build", "seconds": round(seconds, 3),
          "kernels": {n: {"library": str(i.path.name),
                          "nvcc_seconds": round(i.seconds, 3),
                          "ptxas": build.ptxas_report(n).splitlines()}
                      for n, i in infos.items()},
          "ragged_paged_attention_dynamic_smem_bytes": smem})


def phase_kernel_vs_plain(cfg: dict, device: torch.device) -> float:
    """Kernel against its plain version: decode rows, a chunk starting
    mid-prompt at a block-aligned position, one at an off-stride
    position, a whole prompt, pad tiles and the null row; MHA and GQA;
    f32 against the plain version in f32 (atol 1e-4) and bf16 against
    the plain version in f32 on the same bf16 values (atol 2e-2)."""
    bs, tq, d, h = cfg["block_size"], cfg["tile_q"], cfg["head_dim"], \
        cfg["num_heads"]
    rows = cfg["check_rows"]
    worst = 0.0
    for hkv in (h, cfg["gqa_kv_heads"]):
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = ragged_args(rows, h, hkv, d, bs, tq, cfg["check_blocks"],
                               cfg["max_blocks"], 2, dtype, device, SEED)
            got = paged.ragged_paged_attention(*args)
            plain = paged.ragged_paged_attention_reference(
                *[a.float() if a.is_floating_point() else a
                  for a in args])
            if device.type == "cuda":
                torch.cuda.synchronize()
            err = float((got.float() - plain).abs().max())
            check(bool(torch.isfinite(got).all()), "non-finite kernel output")
            emit({"phase": "kernel_vs_plain", "kernel":
                  "ragged_paged_attention", "heads": h, "kv_heads": hkv,
                  "dtype": str(dtype).replace("torch.", ""),
                  "tokens": int(args[0].shape[0]), "max_abs_err": err,
                  "atol": atol, "ok": err <= atol})
            check(err <= atol, f"kernel vs plain: {err} > {atol} "
                               f"(hkv={hkv}, {dtype})")
            worst = max(worst, err)
    return worst


def phase_kernel_time(cfg: dict, device: torch.device, card: dict) -> dict:
    """Kernel, plain version and bound at the engine's step shape.
    Launches cycle over one pool copy per model layer, as the engine's
    step does, so the 50 MB L2 cache does not hold a launch's K/V
    blocks for the next one."""
    cuda = device.type == "cuda"
    args = ragged_args(cfg["time_rows"], cfg["num_heads"],
                       cfg["num_heads"], cfg["head_dim"], cfg["block_size"],
                       cfg["tile_q"], cfg["num_blocks"], cfg["max_blocks"],
                       cfg["time_pad_tiles"], cfg["dtype"], device, SEED + 1)
    q, meta = args[0], args[3:]
    pools = itertools.cycle(
        [(args[1], args[2])] + [(args[1].clone(), args[2].clone())
                                for _ in range(cfg["lm"]["num_layers"] - 1)])

    def launch(fn):
        k_pool, v_pool = next(pools)
        return fn(q, k_pool, v_pool, *meta)

    ms = time_ms(lambda: launch(paged.ragged_paged_attention),
                 cfg["time_iters"], 10, cuda)
    plain_ms = time_ms(
        lambda: launch(paged.ragged_paged_attention_reference),
        cfg["plain_iters"], 2, cuda)
    nbytes, flops = step_cost(args, args[0].element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "bytes": nbytes, "flops": flops}
    emit({"phase": "kernel_time", "kernel": "ragged_paged_attention",
          "tokens": int(args[0].shape[0]), "rows": len(cfg["time_rows"]),
          "device": card["kind"], "nvidia_smi": card["smi"], **out,
          "note": "library_ms null: no single PyTorch call computes a "
                  "block-table-gathered ragged attention"})
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


def phase_engine(cfg: dict, tree: dict, device: torch.device,
                 card: dict) -> dict:
    """The main path: a ServeEngine at full width serving two waves of
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
    paged.ragged_paged_attention.launches = 0       # the main path's count
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
    launches = paged.ragged_paged_attention.launches
    peak = torch.cuda.max_memory_allocated() if cuda else None

    reqs = reqs1 + reqs2
    for r in reqs:
        check(r.finish_reason == "length" and len(r.generated) == n_new,
              f"request {r.req_id} ended {r.finish_reason!r} after "
              f"{len(r.generated)} tokens")
    stats = engine.stats()
    layers = len(model.blocks)
    want = engine.steps * layers if cuda else 0
    check(launches == want, f"kernel launches {launches} != steps "
                            f"{engine.steps} x {layers} layers")
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
        # the engine's busiest step shape: a 456-token chunk from 256
        # plus 7 decode rows; 72 tiles = 576 flat tokens
        time_rows=[(712, 456)] + [(300 + 150 * i, 1) for i in range(7)],
        time_pad_tiles=8, time_iters=200, plain_iters=5)


def tiny_config() -> dict:
    return dict(
        lm=dict(model_dim=64, num_heads=8, num_layers=2, ffn_dim=128,
                dropout=0.0),
        vocab=97, max_len=256, dtype=torch.float32, num_heads=8, head_dim=8,
        gqa_kv_heads=2, block_size=16, tile_q=8, num_blocks=64,
        max_blocks=16, max_batch=4, max_prefill=48, max_new=6, prefix=32,
        long_prompt=100,
        check_rows=[(30, 1), (47, 1), (48, 16), (45, 10), (9, 9)],
        check_blocks=32,
        time_rows=[(60, 40)] + [(20 + 5 * i, 1) for i in range(3)],
        time_pad_tiles=1, time_iters=3, plain_iters=2)


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
    err = phase_kernel_vs_plain(cfg, device)
    timing = phase_kernel_time(cfg, device, card)
    lm = cfg["lm"]
    tree = causal_lm_tree(SEED, cfg["vocab"], lm["model_dim"],
                          lm["num_heads"], lm["num_layers"], lm["ffn_dim"])
    phase_step_vs_dense(cfg, tree, device)
    eng = phase_engine(cfg, tree, device, card)

    emit({"kernels": [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/kernels/paged_attention.py:428",
        "launches": eng["kernel_launches"],
        "launched": eng["kernel_launches"], "checked": True,
        "max_abs_err": err, "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": None}]})
    if cuda:
        emit({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                     "count": card["count"]}})
    else:
        emit({"ok": True, "rehearsal": True,
              "device": {"platform": "cpu", "kind": "cpu", "count": 0}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
