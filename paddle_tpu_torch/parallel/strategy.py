"""Distribution strategy config (port of paddle_tpu/parallel/strategy.py,
whole).

Capability-equivalent of the reference's strategy objects:
- BuildStrategy (details/build_strategy.h:26-101): ReduceStrategy
  {kAllReduce,kReduce}, gradient scale strategy, fuse knobs, num_trainers.
- ExecutionStrategy (details/execution_strategy.h:22).
- DistributeTranspilerConfig (distribute_transpiler.py:130).

The port's `MeshTrainer` (parallel/trainer.py) honours every knob over
a mesh of ranks. `sequence_axis` is accepted and read by nothing, as in
JAX: the sp axis is the loss function's business (`pipelined_lm_loss`'s
`sp_axis`). `donate_state` changes nothing in the port: its trainers
update the state in place.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple


class ReduceStrategy(enum.Enum):
    """≈ details/build_strategy.h:55 ReduceStrategy."""
    ALL_REDUCE = "all_reduce"   # replicate params, psum grads (DP)
    REDUCE = "reduce"           # shard params+opt state (ZeRO/fsdp axis)


class GradientScaleStrategy(enum.Enum):
    """≈ build_strategy.h:57 kCoeffNumDevice/kOne/kCustomized."""
    COEFF_NUM_DEVICE = "coeff_num_device"  # mean over global batch (default)
    ONE = "one"
    CUSTOMIZED = "customized"


@dataclasses.dataclass
class DistStrategy:
    """All parallelism knobs in one place.

    reduce_strategy=REDUCE with fsdp>1 in the mesh is the reference's
    ReduceSSAGraphBuilder capability (param-sharded update + broadcast,
    multi_devices_graph_pass.h:134) == ZeRO-style sharding.
    gradient_accumulation ≈ ir/multi_batch_merge_pass.h:29.
    """
    reduce_strategy: ReduceStrategy = ReduceStrategy.ALL_REDUCE
    gradient_scale: GradientScaleStrategy = \
        GradientScaleStrategy.COEFF_NUM_DEVICE
    gradient_accumulation_steps: int = 1
    # remat/checkpointing policy for memory (≈ memory_optimize pass intent)
    remat: bool = False
    # batch axes the input pipeline shards over
    batch_axes: Tuple[str, ...] = ("dp", "fsdp")
    # sequence axis for context parallelism (ring attention)
    sequence_axis: Optional[str] = None
    # donate old state buffers (≈ inplace_op_pass)
    donate_state: bool = True
    # loss scaling for bf16/fp16 training
    loss_scale: Optional[float] = None
    # bad-step guard (resilience layer): with a budget N, a step whose
    # loss or any grad is non-finite applies NO update (the state is left
    # as it was) and after N consecutive such steps the trainer
    # raises BadStepBudgetExceeded for a checkpoint rollback. None
    # disables the guard (no extra isfinite reduction, no host sync).
    bad_step_budget: Optional[int] = None
