"""The op library of the port (paddle_tpu/ops counterpart): the
functional ops (re-exported here by name, as JAX's package does), the
ragged-sequence ops, control flow, the CRF and CTC lattices, the
detection family, the long-tail extras, beam search and the fused
cross-entropy."""

from paddle_tpu_torch.ops.functional import *  # noqa: F401,F403
from paddle_tpu_torch.ops import (
    control_flow, detection, extras, functional, lattice, sequence)
from paddle_tpu_torch.ops.lattice import (
    crf_decoding, ctc_align, ctc_loss, linear_chain_crf)
from paddle_tpu_torch.ops.beam_search import BeamResult, beam_search, tile_beams
from paddle_tpu_torch.ops.control_flow import (
    case, cond, fori_loop, piecewise, static_rnn, switch, while_loop)
from paddle_tpu_torch.ops.fused_ce import (DEFAULT_CHUNK, effective_chunk,
                                           linear_cross_entropy)
