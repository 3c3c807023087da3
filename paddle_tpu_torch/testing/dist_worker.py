"""Worker of the multi-process tests (the port's counterpart of
tests/dist_worker.py): every rank runs this module; the parent compares
the JSON line each prints.

    python -m paddle_tpu_torch.parallel.launch --nproc 2 --device cpu \\
        -m paddle_tpu_torch.testing.dist_worker

1. bootstrap: init_distributed from the PTPU_* environment;
2. a collective over the world's dp mesh: the sum of every rank's
   (rank + 1);
3. training: 3 MeshTrainer steps (Adam) of an MLP on a dp mesh over
   every rank, each rank putting its slice of one fixed global batch.

Prints ONE json line: {"proc", "nprocs", "psum", "losses"}.

Metrics mode (PTPU_WORKER_METRICS=1): each rank serves its training
telemetry on a live MetricsServer, scrapes its own /metrics and puts the
body in the JSON line, 6 steps; PTPU_WORKER_SLOW_PROC names the rank
whose input pipeline sleeps PTPU_WORKER_SLOW_MS a step (the straggler).
"""

import json
import os
import sys
import time


def main() -> int:
    import numpy as np
    import torch

    from paddle_tpu_torch.core import supervised_loss
    from paddle_tpu_torch.models.vision import MLP
    from paddle_tpu_torch.ops import functional as F
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.parallel import (MeshConfig, MeshTrainer,
                                           collective, make_mesh)
    from paddle_tpu_torch.parallel.distributed import (
        init_distributed, process_count, process_index)

    init_distributed()
    nprocs, proc = process_count(), process_index()
    mesh = make_mesh(MeshConfig(dp=nprocs))
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)
    one = torch.tensor([float(proc + 1)], device=mesh.device)
    group = mesh.maybe_group("dp")
    psum = float((collective.all_reduce(one, group) if group else one)[0])

    torch.manual_seed(0)
    model = MLP(hidden=(16,), num_classes=4, in_shape=(6, 1, 1),
                device=mesh.device)
    trainer = MeshTrainer(
        model, Adam(model.parameters(), 1e-2),
        supervised_loss(lambda lg, y: F.softmax_with_cross_entropy(lg, y)),
        mesh)
    rs = np.random.RandomState(0)              # the same on every rank
    gx = rs.randn(16, 6).astype(np.float32)
    gy = rs.randint(0, 4, 16).astype(np.int64)
    out = {"proc": proc, "nprocs": nprocs, "psum": psum}

    metrics = os.environ.get("PTPU_WORKER_METRICS") == "1"
    srv = h_input = None
    slow_ms = 0.0
    if metrics:
        from paddle_tpu_torch.obs.http import MetricsServer
        from paddle_tpu_torch.obs.metrics import MetricsRegistry
        reg = MetricsRegistry()
        trainer.enable_metrics(reg)
        h_input = reg.histogram(
            "ptpu_train_input_wait_ms",
            "Host wall time producing the step's input batch")
        if os.environ.get("PTPU_WORKER_SLOW_PROC") == str(proc):
            slow_ms = float(os.environ.get("PTPU_WORKER_SLOW_MS", "30"))
        srv = MetricsServer(reg).start()

    losses = []
    for i in range(6 if metrics else 3):
        t0 = time.perf_counter()
        if slow_ms:
            time.sleep(slow_ms / 1e3)   # the wedged input pipeline
        batch = trainer.put_batch((gx, gy))
        if metrics:
            h_input.observe((time.perf_counter() - t0) * 1e3)
        losses.append(float(trainer.train_step(
            batch, generator=torch.Generator(mesh.device).manual_seed(i))[
                "loss"]))
    out["losses"] = losses
    if metrics:
        import urllib.request
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            out["exposition"] = resp.read().decode("utf-8")
        srv.stop()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
