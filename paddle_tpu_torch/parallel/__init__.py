"""Parallel training of the port (paddle_tpu/parallel counterpart):
meshes of ranks over torch.distributed (`make_mesh`, `local_mesh`),
sharding rules and the rank's slices of a tree (`shard_variables`,
`named_sharding`), the differentiable collectives, `MeshTrainer` (data,
ZeRO and Megatron tensor parallelism over the dp, fsdp and tp axes),
`ShardedEmbedding`, the launcher (`parallel.launch`) and the
Kubernetes job generator (`parallel.kube`); the sp, pp and ep axes:
ring and Ulysses attention (`parallel.ring`), the GPipe and 1F1B
pipelines with `PipelinedLM` / `PipelinedMoELM` (`parallel.pipeline`)
and MoE dispatch (`parallel.moe`)."""

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
from paddle_tpu_torch.parallel.pipeline import (
    PipelinedLM, PipelinedMoELM, pipeline_apply, pipeline_loss_fn,
    pipeline_moe_rules, pipeline_rules, pipeline_stream, pipelined_lm_loss,
    pipelined_moe_lm_loss, stack_stage_params)
from paddle_tpu_torch.parallel.moe import (
    init_moe_params, load_balancing_loss, moe_ffn, moe_ffn_a2a,
    moe_ffn_local, moe_partition_specs)
from paddle_tpu_torch.parallel.ring import (
    ring_attention, ring_attention_inner, ring_flash_attention,
    ulysses_attention, zigzag_shard, zigzag_unshard)

__all__ = ["DistStrategy", "GradientScaleStrategy", "Mesh", "MeshConfig",
           "MeshTrainer", "ReduceStrategy", "ShardingRules", "collective",
           "current_mesh", "fsdp_rules", "init_distributed", "local_mesh",
           "make_mesh", "named_sharding", "process_count", "process_index",
           "serve_tp_rules", "shard_variables", "transformer_tp_rules",
           "PipelinedLM", "PipelinedMoELM", "pipeline_apply",
           "pipeline_loss_fn", "pipeline_moe_rules", "pipeline_rules",
           "pipeline_stream", "pipelined_lm_loss", "pipelined_moe_lm_loss",
           "stack_stage_params", "init_moe_params", "load_balancing_loss",
           "moe_ffn", "moe_ffn_a2a", "moe_ffn_local", "moe_partition_specs",
           "ring_attention", "ring_attention_inner", "ring_flash_attention",
           "ulysses_attention", "zigzag_shard", "zigzag_unshard"]
