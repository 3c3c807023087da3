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
Then the sp, pp and ep axes (paddle_tpu_torch/testing/parallel_cases.py,
`PARALLEL`): ring flash attention (kernels 4-6 on each block, f32; the
ppermutes grouped on NCCL) and Ulysses (all_to_all) on sp=4, PipelinedLM
on pp=2 x dp=2 under GPipe and 1F1B, and the MoE FFN's masked and
all_to_all dispatch on ep=4, each held against the same case on one CPU
rank at its CPU test's bars. Prints the cards' names and power limits,
a JSON line a scenario or case, and last {"ok": ...}; exits 1 when a bar
fails. Imports no JAX.
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


# the 10b cases: key -> (how the ranks' pieces join, rtol, atol).
# "sp": concatenated along the sequence in rank order (zig-zag keys
# unsharded after), "tok": token shards on dim 0, "exp": expert slices
# on dim 0, "sum": summed over the ranks, "rep": the same on every rank
RING_KEYS = {f"{n}/{t}": ("sp", 2e-4 if t == "out" else 5e-3,
                          2e-4 if t == "out" else 5e-3)
             for n in ("full", "causal", "causal_grads", "zigzag",
                       "nondivisible")
             for t in ("out", "dq", "dk", "dv")}
MOE_KEYS = {"ep/y": ("rep", 2e-5, 2e-5), "topk/y": ("rep", 2e-5, 2e-5),
            "a2a1/y": ("tok", 2e-5, 2e-5), "a2a2/y": ("tok", 2e-5, 2e-5),
            "a2a_grads/gate": ("sum", 5e-3, 5e-3),
            "a2a_grads/w1": ("exp", 5e-3, 5e-3),
            "a2a_grads/w2": ("exp", 5e-3, 5e-3),
            "masked_grads/gate": ("rep", 5e-3, 5e-3),
            "masked_grads/w1": ("exp", 5e-3, 5e-3),
            "masked_grads/w2": ("exp", 5e-3, 5e-3)}
PARALLEL = {"ring_flash4": RING_KEYS,
            "ulysses4": {f"{t}": ("sp", 2e-4 if t == "out" else 5e-3,
                                  2e-4 if t == "out" else 5e-3)
                         for t in ("out", "dq", "dk", "dv")},
            "moe4": MOE_KEYS,
            "nccl_pipe": None}


def _joined(ranks, key: str, how: str) -> np.ndarray:
    parts = [r[key] for r in ranks]
    if how == "sp":
        out = np.concatenate(parts, 1)
        if key.startswith("zigzag/"):
            import torch
            from paddle_tpu_torch.parallel.ring import zigzag_unshard
            out = zigzag_unshard(torch.from_numpy(out), len(ranks)).numpy()
        return out
    if how in ("tok", "exp"):
        return np.concatenate(parts, 0)
    if how == "sum":
        return np.sum(parts, 0)
    for p in parts[1:]:
        np.testing.assert_array_equal(p, parts[0])
    return parts[0]


def parallel_lines(world, single) -> list:
    """A JSON line a 10b case: each key's largest gap and whether it held
    its bar; the pipeline's losses, gradients and stepped parameters of
    both schedules against one CPU rank's and each other."""
    from paddle_tpu_torch.testing import mesh_cases as M
    from paddle_tpu_torch.testing import parallel_cases as PC
    lines = []
    for name, keys in PARALLEL.items():
        ranks, one = world[name], single[name]
        gaps, ok = {}, True
        if keys is None:                      # the pipeline
            for run in ("gpipe", "f1b"):
                for what, rtol, atol in (("grads", 5e-3, 5e-3),
                                         ("step1/params", 2e-3, 2e-3)):
                    got = M.join(ranks, f"{run}/{what}")
                    want = M.join([one], f"{run}/{what}")
                    for k, w in want.items():
                        g, held = _gap(got[k], w, rtol, atol)
                        gaps[f"{run}/{what}/{k}"] = g
                        ok = ok and held
                for res in ranks:
                    g, held = _gap(res[f"{run}/losses"],
                                   one[f"{run}/losses"], 2e-4, 0.0)
                    gaps[f"{run}/losses"] = max(
                        gaps.get(f"{run}/losses", 0.0), g)
                    ok = ok and held
            g, held = _gap(ranks[0]["f1b/losses"], ranks[0]["gpipe/losses"],
                           1e-5, 0.0)
            gaps["f1b_vs_gpipe/losses"] = g
            ok = ok and held
        else:
            for key, (how, rtol, atol) in keys.items():
                if key not in one:            # a case without gradients
                    continue
                g, held = _gap(_joined(ranks, key, how), one[key], rtol,
                               atol)
                gaps[key] = g
                ok = ok and held
        worst = max(gaps, key=gaps.get)
        lines.append({"case": name, "mesh": PC.CASES[name][0],
                      "max_abs_gap": gaps[worst], "worst": worst,
                      "keys": len(gaps), "ok": ok})
    return lines


def main() -> int:
    import torch
    if torch.cuda.device_count() < 4:
        print(f"chip_mesh_nccl: {torch.cuda.device_count()} CUDA devices, "
              "4 needed", file=sys.stderr)
        return 2
    from paddle_tpu_torch.testing import mesh_cases as M
    from paddle_tpu_torch.testing import parallel_cases as PC

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
    # the sp, pp and ep axes: one 4-rank world, every case against the
    # same case on one CPU rank
    from paddle_tpu_torch.parallel import make_mesh
    par = PC.run_world(4, list(PARALLEL), device=None, timeout=600.0)
    torch.set_num_threads(8)
    one = make_mesh(devices=["cpu"])
    single = {name: PC.CASES[name][1](one) for name in PARALLEL}
    for line in parallel_lines(par, single):
        ok = ok and line["ok"]
        print(json.dumps(line), flush=True)
    print(json.dumps({"ok": ok, "ranks": 4, "backend": "nccl"}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
