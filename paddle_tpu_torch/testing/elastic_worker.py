"""Worker of the fault-injection and elastic-restart tests (the port's
counterpart of tests/elastic_worker.py). The loop runs under the
resilience runtime (`train_resilient` + `RunSupervisor`) over a dp
MeshTrainer across every rank, so every injected failure takes the
real recovery path:

    PTPU_FAULT_PROC/PTPU_FAULT_STEP   hard crash (os._exit 17) mid-run
    PTPU_CHAOS_SIGTERM_STEP           preemption: emergency checkpoint,
                                      exit PREEMPT_EXIT_CODE
    PTPU_ASYNC_CKPT=1                 checkpoints written by a worker
                                      thread (its barriers on the store)

Recovery is checkpoint/resume: a sharded checkpoint every
PTPU_SAVE_EVERY steps through CheckpointManager; on start each rank
restores its pieces of the newest intact one and continues. Batches are
keyed by the global step, so an interrupted and restarted run
reproduces the uninterrupted loss curve.

Prints ONE json line: {"proc", "start_step", "steps", "losses"}
(resilience events come before it as JSON lines with an "evt" key).
"""

import json
import os
import sys


def main() -> int:
    import numpy as np
    import torch

    from paddle_tpu_torch.core import supervised_loss
    from paddle_tpu_torch.io.checkpoint import CheckpointManager
    from paddle_tpu_torch.models.vision import MLP
    from paddle_tpu_torch.ops import functional as F
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.parallel import (DistStrategy, MeshConfig,
                                           MeshTrainer, make_mesh)
    from paddle_tpu_torch.parallel.distributed import (
        init_distributed, process_count, process_index)
    from paddle_tpu_torch.resilience.supervisor import (RunSupervisor,
                                                        train_resilient)

    init_distributed()
    proc, nprocs = process_index(), process_count()
    ckpt_dir = os.environ["PTPU_CKPT_DIR"]
    total_steps = int(os.environ.get("PTPU_TOTAL_STEPS", "6"))
    fault_proc = int(os.environ.get("PTPU_FAULT_PROC", "-1"))
    fault_step = int(os.environ.get("PTPU_FAULT_STEP", "-1"))
    save_every = int(os.environ.get("PTPU_SAVE_EVERY", "1"))
    budget = int(os.environ.get("PTPU_BAD_STEP_BUDGET", "0"))

    mesh = make_mesh(MeshConfig(dp=nprocs))
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)
    torch.manual_seed(0)
    model = MLP(hidden=(16,), num_classes=4, in_shape=(6, 1, 1),
                device=mesh.device)
    trainer = MeshTrainer(
        model, Adam(model.parameters(), 1e-2),
        supervised_loss(lambda lg, y: F.softmax_with_cross_entropy(lg, y)),
        mesh, strategy=DistStrategy(bad_step_budget=budget or None))
    mgr = CheckpointManager(
        ckpt_dir, max_to_keep=int(os.environ.get("PTPU_MAX_TO_KEEP", "2")),
        async_save=bool(int(os.environ.get("PTPU_ASYNC_CKPT", "0"))))
    restored, start_step = mgr.restore_latest(trainer.state())
    if restored is not None:
        trainer.load_state(restored)
    else:
        start_step = 0

    def batch_for(step):
        if proc == fault_proc and step == fault_step:
            os._exit(17)     # a hard crash: no cleanup, no checkpoint
        rs = np.random.RandomState(1000 + step)     # keyed by global step
        gx = rs.randn(8, 6).astype(np.float32)
        gy = rs.randint(0, 4, 8).astype(np.int64)
        return trainer.put_batch((gx, gy))

    steps, losses = [], []

    def on_step(step, fetches):
        steps.append(step)
        losses.append(float(fetches["loss"]))

    with RunSupervisor(mgr) as sup:
        train_resilient(
            trainer, batch_for, total_steps, mgr, start_step=start_step,
            save_every=save_every, supervisor=sup, on_step=on_step,
            generator_for_step=lambda s: torch.Generator(
                mesh.device).manual_seed(s))
    print(json.dumps({"proc": proc, "start_step": start_step,
                      "steps": steps, "losses": losses}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
