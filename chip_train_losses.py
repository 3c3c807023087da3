#!/usr/bin/env python3
"""Loss trajectory of chip_smoke.py's `train` path on one NVIDIA GPU.

    python3 chip_train_losses.py                   # this checkout
    python3 chip_train_losses.py --root DIR        # another checkout's port
    python3 chip_train_losses.py --plain dq        # kernel 5's plain version

Trains the bf16 CausalLM of chip_smoke.py's `train` phase (LM_BASE,
B 4 x T 2048, Adam at lr 3e-3: the same weights, seed, warm-up step and
batch) for its counted steps and prints one JSON line: the losses, the
step times, the card, and how far bf16 kernel 5 lies from its plain
version on one call at the train phase's attention shape (B 4, T 2048,
H 8, D 64, causal): the largest and the mean absolute error against the
plain version's unrounded f32 dq. `--root` imports `chip_smoke` and
`paddle_tpu_torch` from another checkout (e.g. a parent commit unpacked
into build/); `--plain` sends FlashCore's forward, dq or dk/dv (any of
fwd, dq, dkv) through its plain PyTorch version on the card. The flash
kernels launch the same bytes every time, so two runs of one setup give
one trajectory: run two checkouts, or two routes, in one call to tell
a change of arithmetic from a fault. Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout whose port is trained")
    ap.add_argument("--plain", nargs="*", default=[],
                    choices=("fwd", "dq", "dkv"),
                    help="flash kernels to replace by their plain versions")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        print("chip_train_losses: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.core import Trainer
    from paddle_tpu_torch.kernels import flash
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.testing import causal_lm_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.full_config()
    lm = cfg["lm"]
    tree = causal_lm_tree(cs.SEED, cfg["vocab"], lm["model_dim"],
                          lm["num_heads"], lm["num_layers"], lm["ffn_dim"])
    device = torch.device("cuda")
    model = cs._lm(cfg, tree, cfg["dtype"], device)
    trainer = Trainer(model, Adam(model.parameters(), cfg["train_lr"]),
                      cs.lm_loss, seed=cs.SEED)
    warm, fixed = cs._lm_batches(cfg, 2, cfg["train_batch"], device,
                                 cs.SEED + 9)
    b, t, h, d = cfg["flash_time"]
    q, k, v, do = cs._flash_inputs(b, t, h, h, d, torch.bfloat16, device,
                                   cs.SEED + 11)
    kw = dict(scale=d ** -0.5, causal=True)
    o, lse = flash.flash_fwd(q, k, v, **kw)
    f32 = [x.float() for x in (q, k, v, o, lse, do)]
    err = (flash.flash_dq(q, k, v, o, lse, do, **kw).float()
           - flash.flash_dq_reference(*f32, **kw)).abs()
    dq_vs_plain = {"max_abs": float(err.max()),
                   "mean_abs": float(err.mean())}
    for name in args.plain:
        setattr(flash, f"flash_{name}",
                getattr(flash, f"flash_{name}_reference"))
    trainer.train_step(warm)
    losses, step_ms = [], []
    for _ in range(cfg["train_steps"]):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(fixed)["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"root": args.root or ".", "plain": args.plain,
                      "losses": losses, "step_ms": step_ms,
                      "dq_vs_plain": dq_vs_plain,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
