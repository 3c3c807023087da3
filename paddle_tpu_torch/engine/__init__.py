"""Online inference engine of the port (paddle_tpu/engine counterpart):
refcounted paged KV cache with a host tier behind it, continuous-batching
scheduler with speculative drafts and n-best forks, serve loop."""

from paddle_tpu_torch.engine.draft import NgramDrafter
from paddle_tpu_torch.engine.engine import ServeEngine, serve_metadata
from paddle_tpu_torch.engine.kvtier import HostKVTier, prefix_digest
from paddle_tpu_torch.engine.paged_cache import CacheExhausted, PagedKVCache
from paddle_tpu_torch.engine.scheduler import (PrefillChunk, Request,
                                               Scheduler, StepRow)

__all__ = ["CacheExhausted", "HostKVTier", "NgramDrafter", "PagedKVCache",
           "PrefillChunk", "Request", "Scheduler", "ServeEngine", "StepRow",
           "prefix_digest", "serve_metadata"]
