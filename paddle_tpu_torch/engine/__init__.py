"""Online inference engine of the port (paddle_tpu/engine counterpart):
refcounted paged KV cache, continuous-batching scheduler, serve loop."""

from paddle_tpu_torch.engine.engine import ServeEngine, serve_metadata
from paddle_tpu_torch.engine.paged_cache import CacheExhausted, PagedKVCache
from paddle_tpu_torch.engine.scheduler import Request, Scheduler, StepRow

__all__ = ["CacheExhausted", "PagedKVCache", "Request", "Scheduler",
           "ServeEngine", "StepRow", "serve_metadata"]
