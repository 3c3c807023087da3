"""Parallel training of the port (paddle_tpu/parallel counterpart):
meshes of ranks over torch.distributed (`make_mesh`, `local_mesh`),
sharding rules and the rank's slices of a tree (`shard_variables`,
`named_sharding`), the differentiable collectives, `MeshTrainer` (data,
ZeRO and Megatron tensor parallelism over the dp, fsdp and tp axes),
`ShardedEmbedding`, the launcher (`parallel.launch`) and the
Kubernetes job generator (`parallel.kube`). The sp, pp and ep axes
(ring attention, pipelines, MoE) are ROADMAP.md item 10b."""

from paddle_tpu_torch.parallel.mesh import (Mesh, MeshConfig, current_mesh,
                                            local_mesh, make_mesh)
from paddle_tpu_torch.parallel.strategy import (
    DistStrategy, GradientScaleStrategy, ReduceStrategy)
from paddle_tpu_torch.parallel.sharding import (
    ShardingRules, fsdp_rules, named_sharding, serve_tp_rules,
    shard_variables, transformer_tp_rules)
from paddle_tpu_torch.parallel.trainer import MeshTrainer
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel.distributed import (
    init_distributed, process_count, process_index)

__all__ = ["DistStrategy", "GradientScaleStrategy", "Mesh", "MeshConfig",
           "MeshTrainer", "ReduceStrategy", "ShardingRules", "collective",
           "current_mesh", "fsdp_rules", "init_distributed", "local_mesh",
           "make_mesh", "named_sharding", "process_count", "process_index",
           "serve_tp_rules", "shard_variables", "transformer_tp_rules"]
