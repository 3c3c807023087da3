#!/usr/bin/env python3
"""Kernels 1 and 2 under other kv schedules on one NVIDIA GPU.

    python3 chip_ragged_sweep.py                          # S 256 384 448
    python3 chip_ragged_sweep.py --splits 256 512 --chunks 64 32

Times the ragged kernels at chip_smoke.py's `kernel_time` shape (a
456-token chunk from 256 plus 7 decode rows; LM widths, H 8, D 64, block
16, tile 8; launches cycling over one pool copy per model layer) with the
wrapper's schedule swapped for each (split S, chunk C) given: kernel 1
(fp pools) and kernel 2 (every other block before each row's query
window int8-resident), in bf16 and f32. The kernels take S and C as
arguments, so no rebuild is needed. Configurations run forward, then in
reverse, in one process on one card (A B C C B A), so a drift of the card
shows as a gap between a configuration's two lines.

Prints one JSON line per run: the card, the schedule, each kernel's
device time (`torch.profiler`, summed over --iters calls, split and
combine kernels apart) and the largest difference from the shipped
schedule's output (S and C set the order of the sums, so bits differ).
Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys

import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import paged_attention as paged


def per_kernel_ms(fn, iters: int) -> dict:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name, us in cs.device_events(prof).items():
        key = ("split" if "split_kernel" in name else
               "combine" if "combine_kernel" in name else name)
        out[key] = out.get(key, 0.0) + us / 1e3 / iters
    return out


def schedule_with(split: int, chunk):
    """The wrapper's schedule with S = split and, if given, C = chunk."""
    shipped = paged.ragged_schedule.__wrapped__

    def sched(dtype, head_dim, rows, block_size):
        s = shipped(dtype, head_dim, rows, block_size)
        c = chunk or s.chunk
        elem = 2 if dtype == torch.bfloat16 else 4
        return s._replace(
            split=split, chunk=c, threads=c // paged.RAGGED_LANES * 32,
            smem_bytes=paged.ragged_smem_bytes(head_dim, elem, c, split,
                                               block_size, s.warp_rows))
    return sched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", type=int, nargs="+", default=[256, 384, 448])
    ap.add_argument("--chunks", type=int, nargs="+", default=[0],
                    help="0: the shipped chunk")
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_ragged_sweep: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cfg = cs.full_config()
    dev = torch.device("cuda")
    h, d, bs = cfg["num_heads"], cfg["head_dim"], cfg["block_size"]
    layers = cfg["lm"]["num_layers"]
    shipped = paged.ragged_schedule
    configs = [(s, c or None) for s in args.splits for c in args.chunks]
    configs = configs + configs[::-1]
    for dtype in (torch.bfloat16, torch.float32):
        geom = (cfg["time_rows"], h, h, d, bs, cfg["tile_q"],
                cfg["num_blocks"], cfg["max_blocks"], cfg["time_pad_tiles"],
                dtype, dev, cs.SEED + 1)
        args1 = cs.ragged_args(*geom)
        q, meta = args1[0], args1[3:]
        pools = itertools.cycle(
            [(args1[1], args1[2])]
            + [(args1[1].clone(), args1[2].clone())
               for _ in range(layers - 1)])
        margs, quant, _, n8 = cs.mixed_args(
            *geom, lambda row, j, q_start: (j + 1) * bs <= q_start
            and j % 2 == 0)
        mpools = itertools.cycle(
            [tuple(margs[1:3]) + (quant["kq_pool"], quant["vq_pool"])]
            + [tuple(x.clone() for x in (margs[1], margs[2],
                                         quant["kq_pool"], quant["vq_pool"]))
               for _ in range(layers - 1)])

        def k1():
            return paged.ragged_paged_attention(q, *next(pools), *meta)

        def k2():
            k, v, kq, vq = next(mpools)
            return paged.ragged_paged_attention(
                q, k, v, *margs[3:], kq_pool=kq, vq_pool=vq,
                k_scales=quant["k_scales"], v_scales=quant["v_scales"])

        ref = (k1().float(), k2().float())
        for split, chunk in configs:
            paged.ragged_schedule = schedule_with(split, chunk)
            try:
                diff = [float((fn().float() - r).abs().max())
                        for fn, r in zip((k1, k2), ref)]
                t1, t2 = per_kernel_ms(k1, args.iters), \
                    per_kernel_ms(k2, args.iters)
            finally:
                paged.ragged_schedule = shipped
            print(json.dumps({
                "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                "dtype": str(dtype).replace("torch.", ""), "split": split,
                "chunk": chunk or shipped(dtype, d, cfg["tile_q"], bs).chunk,
                "kernel_1": t1, "kernel_1_ms": sum(t1.values()),
                "kernel_2": t2, "kernel_2_ms": sum(t2.values()),
                "int8_blocks": n8, "max_abs_diff_vs_shipped": diff}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
