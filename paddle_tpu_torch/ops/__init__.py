"""The op library of the port (paddle_tpu/ops counterpart): the
functional ops (re-exported here by name, as JAX's package does), the
ragged-sequence ops, beam search and the fused cross-entropy."""

from paddle_tpu_torch.ops.functional import *  # noqa: F401,F403
from paddle_tpu_torch.ops import functional, sequence
from paddle_tpu_torch.ops.beam_search import BeamResult, beam_search, tile_beams
from paddle_tpu_torch.ops.fused_ce import (DEFAULT_CHUNK, effective_chunk,
                                           linear_cross_entropy)
