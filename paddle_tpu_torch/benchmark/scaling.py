"""Scaling-efficiency benchmark: per-rank throughput across mesh sizes
(port of paddle_tpu/benchmark/scaling.py).

The BASELINE.md BERT row asks for "8→32 chip scaling efficiency
reported"; the reference's multi-device benchmark is fluid_benchmark.py
with --update_method nccl2 over N GPUs. Here: run the same model at
dp = 1, 2, 4, ... with a fixed per-rank batch (weak scaling), report
per-rank items/s and efficiency vs dp=1.

JAX runs each size as one program over that many devices of its
process; the port runs each size as a world of that many ranks
(parallel/launch.py, one process a rank, this module as each rank's
program): a rank a card over NCCL, or — `device="cpu"` — CPU ranks over
gloo, one torch thread each (plumbing and CI; numbers labeled cpu).

    python -m paddle_tpu_torch.parallel.launch --nproc 2 --device cpu \\
        -m paddle_tpu_torch.benchmark.scaling    # one size, by hand
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def available_ranks(device: Optional[str] = None) -> int:
    """The ranks a size may take: the cards (a rank each), or with
    `device="cpu"` the host's cores."""
    if device == "cpu":
        return os.cpu_count() or 1
    return torch.cuda.device_count()


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run_world(dp: int, model: str, per_chip_batch: int, dtype: str,
              min_time: float, device: Optional[str] = None,
              timeout: float = 600.0) -> Dict[str, Any]:
    """One world of `dp` ranks training `model` at dp; rank 0's
    BenchResult as a dict (unrounded)."""
    from paddle_tpu_torch.parallel.launch import launch
    with tempfile.TemporaryDirectory() as out:
        path = os.path.join(out, "result.json")
        env = {"PYTHONPATH": os.pathsep.join(
                   [_repo_root(), os.environ.get("PYTHONPATH", "")]),
               "PTPU_SCALING": json.dumps(dict(
                   model=model, batch=per_chip_batch * dp, dtype=dtype,
                   min_time=min_time, out=path))}
        launch(dp, [sys.executable, "-m", "paddle_tpu_torch.benchmark.scaling"],
               device=device, env=env, timeout=timeout)
        with open(path) as f:
            return json.load(f)


def run_scaling(model: str = "mlp", sizes: Sequence[int] = (1, 2, 4, 8),
                per_chip_batch: int = 32, dtype=torch.float32,
                min_time: float = 0.5, device: Optional[str] = None,
                timeout: float = 600.0) -> List[Dict[str, Any]]:
    """Weak-scaling sweep: global batch = per_chip_batch * dp.

    Returns one dict per mesh size: {dp, value, unit, per_chip,
    efficiency, ms_per_step, device, platform}, or {dp, skipped} past the
    ranks available. efficiency = per_chip(dp) / per_chip(1)."""
    platform = "cpu" if device == "cpu" else "cuda"
    have = available_ranks(device)
    name = {v: k for k, v in _DTYPES.items()}[dtype]
    results: List[Dict[str, Any]] = []
    base_per_chip: Optional[float] = None
    for dp in sizes:
        if dp > have:
            results.append({"dp": dp, "skipped": f"only {have} devices"})
            continue
        r = run_world(dp, model, per_chip_batch, name, min_time, device,
                      timeout)
        per_chip = r["value"] / dp
        if base_per_chip is None:
            base_per_chip = per_chip
        results.append({
            "dp": dp,
            "value": round(r["value"], 1),
            "unit": r["unit"],
            "per_chip": round(per_chip, 1),
            "efficiency": round(per_chip / base_per_chip, 4),
            "ms_per_step": round(r["ms_per_step"], 2),
            "device": r["device"],
            "platform": platform,
        })
    return results


def scaling_summary(results: List[Dict[str, Any]],
                    prefix: str = "") -> Dict[str, Any]:
    """Compact form: largest-mesh efficiency, labeled with the platform
    it ran on (cpu numbers are plumbing checks, not hardware scaling
    claims).

    CPU ranks SHARE the host's cores, so ideal weak-scaling per-rank
    efficiency is 1/dp, not 1 — `vs_shared_core_ideal` = efficiency*dp
    normalizes that out (≈1.0 means the sharded step and its
    collectives add no overhead beyond the shared silicon)."""
    ran = [r for r in results if "efficiency" in r]
    if not ran:
        return {}
    last = ran[-1]
    out = {f"{prefix}dp{last['dp']}_scaling_eff": last["efficiency"],
           "scaling_platform": last["platform"]}
    if last["platform"] == "cpu":
        out[f"{prefix}dp{last['dp']}_vs_shared_core_ideal"] = round(
            last["efficiency"] * last["dp"], 3)
    return out


def main() -> int:
    """One rank of a run_world size: the model at dp = the world's size;
    rank 0 writes its result where PTPU_SCALING says."""
    import dataclasses

    from paddle_tpu_torch.benchmark.models import run_model
    from paddle_tpu_torch.parallel import (DistStrategy, MeshConfig,
                                           make_mesh)
    from paddle_tpu_torch.parallel.distributed import (init_distributed,
                                                       process_count,
                                                       process_index)
    conf = json.loads(os.environ["PTPU_SCALING"])
    init_distributed()
    devices = os.environ.get("PTPU_DEVICES", "cpu").split(",")
    rank = process_index()
    if torch.device(devices[rank]).type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(torch.device(devices[rank]))
    mesh = make_mesh(MeshConfig(dp=process_count()))
    r = run_model(conf["model"], batch_size=conf["batch"],
                  dtype=_DTYPES[conf["dtype"]], mesh=mesh,
                  strategy=DistStrategy(), min_time=conf["min_time"])
    if rank == 0:
        with open(conf["out"], "w") as f:
            json.dump(dataclasses.asdict(r), f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
