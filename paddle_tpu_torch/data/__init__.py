"""Input pipelines of the port (paddle_tpu/data counterpart): readers and
their decorators, bucketing, transforms, the built-in datasets (pure
numpy copies of the JAX package's) and the host -> device feeders. The
native DataFeed (`data/datafeed.py`) comes with ROADMAP item 10."""

from paddle_tpu_torch.data import (bucketing, common, datasets, readers,
                                   transforms)
from paddle_tpu_torch.data.bucketing import (bucket_boundaries,
                                             bucket_by_length)
from paddle_tpu_torch.data.feeder import DataFeeder, device_prefetch
from paddle_tpu_torch.data.readers import (
    batch, buffered, cache, chain, compose, firstn, map_readers, shuffle,
    xmap_readers)

__all__ = ["bucketing", "common", "datasets", "readers", "transforms",
           "bucket_boundaries", "bucket_by_length", "DataFeeder",
           "device_prefetch", "batch", "buffered", "cache", "chain",
           "compose", "firstn", "map_readers", "shuffle", "xmap_readers"]
