"""Worker: DeepFM with ShardedEmbedding across ranks (the port's
counterpart of tests/dist_worker_deepfm.py). The embedding tables are
row-sharded over the "fsdp" axis spanning every rank, the batch over
"dp" (of size 1 on two ranks, so both look up the same ids and sum their
rows' parts), and the losses must match a single-rank run.

Prints ONE json line: {"proc", "nprocs", "losses", "local_rows",
"total_rows"}.
"""

import json
import sys


def main() -> int:
    import numpy as np
    import torch

    from paddle_tpu_torch.models.nlp import DeepFM
    from paddle_tpu_torch.ops import functional as F
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.parallel import (DistStrategy, MeshConfig,
                                           MeshTrainer, make_mesh)
    from paddle_tpu_torch.parallel.distributed import (
        init_distributed, process_count, process_index)
    from paddle_tpu_torch.parallel.embedding import (ShardedEmbedding,
                                                     embedding_rules)

    init_distributed()
    proc, nprocs = process_index(), process_count()
    mesh = make_mesh(MeshConfig(fsdp=nprocs))
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)
    fields, vocab_per_field, dense_dim = 4, 32, 6
    torch.manual_seed(0)
    model = DeepFM(num_fields=fields, vocab_per_field=vocab_per_field,
                   dense_dim=dense_dim, embed_dim=8, mlp_dims=(32, 32),
                   embedding_cls=ShardedEmbedding, device=mesh.device,
                   axis="fsdp", mesh=mesh, batch_axes=("dp",))
    total_rows = model.table.weight.shape[0]

    def loss_fn(module, batch, generator, training):
        dense, sparse, y = batch
        return torch.mean(F.sigmoid_cross_entropy_with_logits(
            module(dense, sparse), y)), {}

    trainer = MeshTrainer(model, Adam(model.parameters(), 1e-2), loss_fn,
                          mesh, strategy=DistStrategy(batch_axes=("dp",)),
                          rules=embedding_rules("fsdp"))
    rs = np.random.RandomState(100)       # one fixed global batch
    gbs = 16
    batch = trainer.put_batch((
        rs.randn(gbs, dense_dim).astype(np.float32),
        rs.randint(0, vocab_per_field, (gbs, fields)).astype(np.int32),
        rs.randint(0, 2, gbs).astype(np.float32)))
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(4)]
    print(json.dumps({"proc": proc, "nprocs": nprocs, "losses": losses,
                      "local_rows": int(model.table.weight.shape[0]),
                      "total_rows": int(total_rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
