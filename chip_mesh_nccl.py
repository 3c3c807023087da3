#!/usr/bin/env python3
"""Training over a mesh of ranks with NCCL, a card a rank.

    python3 chip_mesh_nccl.py            # needs 4 NVIDIA cards

chip_smoke.py's `mesh_train` runs its ranks on one card over gloo, the
only layout one card allows. This script runs the other one: 4 ranks
(parallel/launch.py, rank i on cuda:i, every axis group on NCCL) through
the scenarios of paddle_tpu_torch/testing/mesh_cases.py that reach each
collective of the trainer's contract: the gradient buckets (dp), ZeRO's
bucketed gathers and their reduce-scatters (fsdp), Megatron tp, the
sharded embedding's reduce-scatter, sync-BN's mean, norm clipping's
sums and the bad-step guard's max. Each is held against the same
scenario on one CPU rank at the bars of the CPU tests
(tests/test_torch_parallel.py, _sparse_embedding.py), on the leaves
those tests hold (`HELD`; the largest gap of every leaf is printed).
Prints the cards' names and power limits, a JSON line a scenario, and
last {"ok": ...}; exits 1 when a bar fails. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

# scenario: (loss rtol, loss atol, parameter rtol, parameter atol)
BARS = {"mlp_dp": (2e-4, 0.0, 1e-4, 1e-5),
        "mlp_zero": (2e-4, 0.0, 1e-4, 1e-5),
        "mlp_clip_global": (1e-5, 0.0, 1e-4, 1e-6),
        "tf_tp": (1e-3, 0.0, 2e-3, 2e-4),
        "bn_sync": (1e-5, 0.0, 1e-5, 1e-6),
        "deepfm_split_ids": (0.0, 1e-5, 1e-5, 1e-6),
        "mlp_guard": (1e-5, 0.0, 1e-4, 1e-6)}
# the parameters a scenario's bar holds where its CPU test holds only
# some (every other leaf is reported, not held): DeepFM's sharded table
HELD = {"deepfm_split_ids": ("table/weight",)}


def _gap(got: np.ndarray, want: np.ndarray, rtol: float,
         atol: float) -> tuple:
    """(largest absolute gap, whether every element is within the bar);
    NaN where both hold NaN (the guard's skipped step) is no gap."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.where(np.isnan(got) & np.isnan(want), 0.0,
                   np.abs(got - want))
    bound = atol + rtol * np.abs(np.nan_to_num(want))
    return float(err.max()), bool(np.all(err <= bound))


def main() -> int:
    import torch
    if torch.cuda.device_count() < 4:
        print(f"chip_mesh_nccl: {torch.cuda.device_count()} CUDA devices, "
              "4 needed", file=sys.stderr)
        return 2
    from paddle_tpu_torch.testing import mesh_cases as M

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    print(smi, flush=True)
    names = list(BARS)
    world = M.run_world(4, names, device=None, timeout=300.0)
    ok = True
    for name in names:
        lr, la, pr, pa = BARS[name]
        single = M.run_single(name)
        ranks = world[name]
        loss_gap, loss_ok = 0.0, True
        for res in ranks:
            g, held = _gap(res["losses"], single["losses"], lr, la)
            loss_gap, loss_ok = max(loss_gap, g), loss_ok and held
        got, want = M.join(ranks, "params"), M.join([single], "params")
        param_ok = sorted(got) == sorted(want)
        gaps = {}
        for path, w in want.items():
            g, held = _gap(got.get(path, np.full_like(w, np.nan)), w, pr, pa)
            gaps[path] = g
            if path in HELD.get(name, want):
                param_ok = param_ok and held
        worst = max(gaps, key=gaps.get)
        line = {"scenario": name, "mesh": M.SCENARIOS[name].mesh,
                "loss_max_abs_gap": loss_gap,
                "params_held": list(HELD.get(name, ["all"])),
                "params_held_max_abs_gap": max(
                    gaps[p] for p in HELD.get(name, gaps)),
                "params_max_abs_gap": gaps[worst], "params_worst": worst,
                "bars": BARS[name], "losses_ok": loss_ok,
                "params_ok": param_ok}
        if name == "mlp_guard":
            line["bad_steps"] = [r["bad"].tolist() for r in ranks]
            line["guard_ok"] = all(b == single["bad"].tolist()
                                   for b in line["bad_steps"])
            ok = ok and line["guard_ok"]
        ok = ok and loss_ok and param_ok
        print(json.dumps(line), flush=True)
    print(json.dumps({"ok": ok, "ranks": 4, "backend": "nccl"}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
