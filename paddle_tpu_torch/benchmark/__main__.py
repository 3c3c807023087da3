"""Benchmark CLI — the fluid_benchmark.py equivalent (port of
paddle_tpu/benchmark/__main__.py, with its flags).

Usage (on the card; `--device cpu` for the CPU):

    python -m paddle_tpu_torch.benchmark --model resnet50 --batch_size 64
    python -m paddle_tpu_torch.benchmark --model all --min_time 2
    python -m paddle_tpu_torch.benchmark --model transformer --infer
    python -m paddle_tpu_torch.parallel.launch --nproc 4 \\
        -m paddle_tpu_torch.benchmark --model transformer --dp 2 --tp 2

--dp/--fsdp/--tp build a mesh over the ranks of a
`paddle_tpu_torch.parallel.launch` world (one process a rank, JAX's
mesh over one process's devices) and run the model under MeshTrainer;
rank 0 prints. --scaling launches a world of its own for each size.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.benchmark",
                                description=__doc__)
    p.add_argument("--model", default="resnet50",
                   help="model name, comma list, or 'all'")
    p.add_argument("--batch_size", type=int, default=None,
                   help="global batch size (default: per-model)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (params stay fp32)")
    p.add_argument("--min_time", type=float, default=2.0,
                   help="minimum timed window in seconds")
    p.add_argument("--dp", type=int, default=0, help="data-parallel axis")
    p.add_argument("--fsdp", type=int, default=0, help="ZeRO/fsdp axis")
    p.add_argument("--tp", type=int, default=0, help="tensor-parallel axis")
    p.add_argument("--gradient_accumulation", type=int, default=1)
    p.add_argument("--json", action="store_true",
                   help="one JSON object per line instead of a table")
    p.add_argument("--infer", action="store_true",
                   help="inference throughput (eval forward, or generated "
                        "tokens of a ServeEngine) instead of training; "
                        "mirrors the reference's infer tables")
    p.add_argument("--scaling", default=None, metavar="SIZES",
                   help="weak-scaling sweep over dp mesh sizes, e.g. "
                        "'1,2,4,8': per-rank throughput + efficiency "
                        "(per-rank batch from --batch_size, default 32)")
    p.add_argument("--resume_file", default=None, metavar="PATH",
                   help="preemption-safe sweeps: append each finished "
                        "model's name here and skip names already present "
                        "on relaunch; SIGTERM between models exits with "
                        "the reschedulable preemption code "
                        "(resilience/supervisor.py)")
    p.add_argument("--device", default=None, choices=["cpu", "cuda"],
                   help="where to run (default: the card)")
    args = p.parse_args(argv)

    from paddle_tpu_torch.benchmark.models import MODELS, run_model

    if args.infer and args.scaling:
        p.error("--infer and --scaling are mutually exclusive")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    if args.scaling:
        from paddle_tpu_torch.benchmark.scaling import run_scaling
        sizes = [int(s) for s in args.scaling.split(",")]
        rows = run_scaling(args.model if args.model != "all" else "mlp",
                           sizes=sizes,
                           per_chip_batch=args.batch_size or 32,
                           dtype=dtype, min_time=args.min_time,
                           device=args.device)
        for row in rows:
            if args.json:
                print(json.dumps(row))
            elif "skipped" in row:
                print(f"dp={row['dp']:<3} skipped ({row['skipped']})")
            else:
                print(f"dp={row['dp']:<3} {row['value']:12.1f} "
                      f"{row['unit']:<9} per-chip {row['per_chip']:10.1f}  "
                      f"eff {row['efficiency'] * 100:6.1f}%  "
                      f"[{row['platform']}]")
        return 0

    if args.infer and (args.dp or args.fsdp or args.tp
                       or args.gradient_accumulation != 1):
        p.error("--infer benchmarks single-device eval throughput; "
                "mesh/accumulation flags do not apply")

    mesh = strategy = rules = None
    rank = 0
    if args.dp or args.fsdp or args.tp:
        from paddle_tpu_torch.parallel import (DistStrategy, MeshConfig,
                                               make_mesh)
        from paddle_tpu_torch.parallel.distributed import (init_distributed,
                                                           process_count,
                                                           process_index)
        from paddle_tpu_torch.parallel.sharding import (
            fsdp_rules, transformer_tp_rules)
        init_distributed()
        rank = process_index()
        if args.device == "cpu":
            torch.set_num_threads(1)
        alone = process_count() == 1      # a mesh of one device
        mesh = make_mesh(MeshConfig(dp=max(args.dp, 1),
                                    fsdp=max(args.fsdp, 1),
                                    tp=max(args.tp, 1)),
                         devices=[args.device or "cuda"] if alone else None)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        strategy = DistStrategy(
            gradient_accumulation_steps=args.gradient_accumulation)
        rules = (transformer_tp_rules() if args.tp > 1
                 else fsdp_rules() if args.fsdp > 1 else None)

    names = (sorted(MODELS) if args.model == "all"
             else [m.strip() for m in args.model.split(",")])

    def say(line: str) -> None:
        if rank == 0:
            print(line, flush=True)

    # Preemption-safe sweep: a long `--model all` run on a preemptible
    # machine records progress per model and checks for a delivered
    # SIGTERM/SIGINT at each model boundary (mid-model state is
    # worthless — a timing window is only meaningful complete).
    supervisor = None
    done: set = set()
    if args.resume_file:
        import os

        from paddle_tpu_torch.resilience.supervisor import RunSupervisor
        if os.path.exists(args.resume_file):
            with open(args.resume_file) as f:
                done = {line.strip() for line in f if line.strip()}
        supervisor = RunSupervisor().install()

    results = []
    for name in names:
        if name in done:
            say(f"{name:>14}  (done in {args.resume_file}; skipped)")
            continue
        if supervisor is not None:
            supervisor.maybe_preempt_exit(None, len(results))
        if args.infer:
            from paddle_tpu_torch.benchmark.models import (INFER_MODELS,
                                                           run_infer)
            if name not in INFER_MODELS:
                say(f"{name:>14}  (no inference benchmark; skipped)")
                continue
            r = run_infer(name, batch_size=args.batch_size or 16,
                          dtype=dtype, min_time=args.min_time,
                          device=args.device)
        else:
            r = run_model(name, batch_size=args.batch_size, dtype=dtype,
                          mesh=mesh, strategy=strategy, rules=rules,
                          min_time=args.min_time, device=args.device)
        results.append(r)
        if args.json:
            say(json.dumps(r.to_dict()))
        else:
            mfu = f"{r.mfu * 100:5.1f}%" if r.mfu is not None else "  n/a"
            tf = (f"{r.tflops_per_sec:7.1f}" if r.tflops_per_sec is not None
                  else "    n/a")
            vs = (f"{r.vs_baseline:8.2f}x" if r.vs_baseline is not None
                  else "     n/a")
            say(f"{name:>14}  {r.value:12.1f} {r.unit:<9} "
                f"{r.ms_per_step:8.2f} ms/step  {tf} TF/s  MFU {mfu}  "
                f"vs_ref {vs}  [{r.device}]")
        if args.resume_file and rank == 0:
            with open(args.resume_file, "a") as f:
                f.write(name + "\n")
    if supervisor is not None:
        supervisor.uninstall()
    if mesh is not None and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
