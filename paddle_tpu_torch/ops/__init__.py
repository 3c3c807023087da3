"""Fused operators of the port (paddle_tpu/ops counterpart)."""

from paddle_tpu_torch.ops.fused_ce import (DEFAULT_CHUNK, effective_chunk,
                                           linear_cross_entropy)

__all__ = ["DEFAULT_CHUNK", "effective_chunk", "linear_cross_entropy"]
