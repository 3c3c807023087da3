"""Input pipelines of the port (paddle_tpu/data counterpart): readers and
their decorators, bucketing, transforms, the built-in datasets (pure
numpy copies of the JAX package's), the host -> device feeders and the
multi-slot DataFeed over slot-format text files (`data/datafeed.py`,
with its native parser `datafeed.cc`)."""

from paddle_tpu_torch.data import (bucketing, common, datasets, readers,
                                   transforms)
from paddle_tpu_torch.data.bucketing import (bucket_boundaries,
                                             bucket_by_length)
from paddle_tpu_torch.data.feeder import DataFeeder, device_prefetch
from paddle_tpu_torch.data.datafeed import (MultiSlotDataFeed, SlotSpec,
                                            to_padded, write_slot_file)
from paddle_tpu_torch.data.readers import (
    batch, buffered, cache, chain, compose, firstn, map_readers, shuffle,
    xmap_readers)

__all__ = ["bucketing", "common", "datasets", "readers", "transforms",
           "bucket_boundaries", "bucket_by_length", "DataFeeder",
           "device_prefetch", "batch", "buffered", "cache", "chain",
           "compose", "firstn", "map_readers", "shuffle", "xmap_readers",
           "MultiSlotDataFeed", "SlotSpec", "to_padded", "write_slot_file"]
