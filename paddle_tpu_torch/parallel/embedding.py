"""Sharded sparse embedding (port of paddle_tpu/parallel/embedding.py):
the parameter-server capability over a mesh axis.

The table lives row-sharded over a mesh axis: each rank owns
`padded_vocab / axis_size` contiguous rows, the table padded up so
every rank owns an equal block. A lookup on the current mesh (the one
MeshTrainer enters) is

    local = ids - my_first_row          (split_ids)
    emb   = take(my_rows, clamp(local)) masked to my range
    out   = sum of emb over the axis    (merge_ids)

so each rank reads only its own rows, and the backward scatters into
the local rows only. When the ranks of the table's axis hold the same
ids (the batch is not sharded over that axis: the trainer's batch axes,
else the module's `batch_axes`) the sum is `reduce_from_axis`. When the
batch IS sharded over the table's axis, peers hold different ids, so
the ids are gathered over the axis first (JAX's shard_map reshards the
ids to P(batch_axes), :137-142), every rank looks all of them up in its
rows, and `reduce_scatter_sum` sums and keeps this rank's own rows —
its backward gathers the peers' gradients, scaled to the mean over the
axis (the trainer averages over the batch axes a leaf is not sharded
on).

Without a current mesh, or when the table is whole, the lookup is a
plain gather. Ids are clamped into the real vocabulary first, on either
path (the JAX module's semantics).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn import initializers as I
from paddle_tpu_torch.parallel.sharding import (ShardingRules, Spec,
                                                local_index)


def _round_up(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


class ShardedEmbedding(nn.Module):
    """Row-sharded embedding table over `axis` (default "fsdp"); a
    drop-in for nn.layers.Embedding, usable as DeepFM's
    `embedding_cls`. `mesh` sizes the padding (the table is built whole,
    [padded_vocab, features], and MeshTrainer cuts it by
    `embedding_rules`); `batch_axes` names how the ids' leading dim is
    sharded outside a trainer. `device` defaults to the card."""

    def __init__(self, num_embeddings: int, features: int,
                 axis: str = "fsdp", mesh=None,
                 batch_axes: Sequence[str] = ("dp",),
                 padding_idx: Optional[int] = None, embedding_init=None,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.features = features
        self.axis = axis
        self.axis_size = mesh.shape[axis] if mesh is not None else 1
        self.batch_axes = tuple(batch_axes)
        self.padding_idx = padding_idx
        self.dtype = dtype
        shape = (self._padded_vocab(), features)
        if embedding_init is None:
            self.weight = nn.Parameter(torch.empty(shape, device=device))
            nn.init.normal_(self.weight, 0.0, 0.02)
        else:
            self.weight = I.parameter(embedding_init, shape, device)

    @property
    def partition_spec(self) -> Spec:
        """The table's rule: rows on `axis`, features whole."""
        return (self.axis, None)

    def local_specs(self):
        return {"weight": self.partition_spec}

    def _padded_vocab(self) -> int:
        return _round_up(self.num_embeddings, max(self.axis_size, 1))

    def _group(self):
        from paddle_tpu_torch.parallel.mesh import current_mesh
        mesh = current_mesh()
        if mesh is None or self.weight.shape[0] == self._padded_vocab():
            return None, None
        return mesh, mesh.group(self.axis)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        lookup = ids.long().clamp(0, self.num_embeddings - 1)
        mesh, group = self._group()
        if group is None:
            out = self.weight[lookup]
        else:
            out = self._sharded_lookup(mesh, group, lookup)
        out = out.to(self.dtype)
        if self.padding_idx is not None:
            out = torch.where((ids != self.padding_idx)[..., None], out,
                              torch.zeros_like(out))
        return out

    def _sharded_lookup(self, mesh, group, ids: torch.Tensor
                        ) -> torch.Tensor:
        from paddle_tpu_torch.parallel import collective as C
        from paddle_tpu_torch.parallel.mesh import current_batch_axes
        rows = self.weight.shape[0]
        first = group.rank * rows
        data_axes = current_batch_axes()
        if data_axes is None:
            data_axes = self.batch_axes
        split = self.axis in mesh.wide(data_axes) and ids.dim() > 0

        def take(ids_):
            local = ids_ - first
            ok = (local >= 0) & (local < rows)
            emb = self.weight[torch.where(ok, local, torch.zeros_like(local))]
            return emb * ok[..., None].to(emb.dtype)

        if not split:
            return C.reduce_from_axis(take(ids), group)
        every = C.all_gather(ids, group, 0)
        return C.reduce_scatter_sum(take(every), group, 0)


def embedding_rules(axis: str = "fsdp",
                    pattern: str = r"(table|embed[^/]*|w1)/weight$"
                    ) -> ShardingRules:
    """Rule table sharding embedding-style params row-wise over `axis`
    (DeepFM's `table`/`w1` and any `embed*` module). Combine with fsdp
    rules via `.add()` for the dense tower."""
    return ShardingRules([(pattern, (axis, None))])


def shard_table(mesh, table, axis: str = "fsdp"):
    """This rank's rows of a whole [V, E] table (numpy or a tensor) on
    `mesh` (the initial 'send blocks to pservers' step)."""
    idx: Tuple[slice, ...] = local_index((axis, None), tuple(table.shape),
                                         mesh.coords, mesh.shape)
    part = table[idx]
    return part.contiguous() if isinstance(part, torch.Tensor) else part.copy()


# -- checkpoint guards --------------------------------------------------------
# The padded table is saved in checkpoints; if num_embeddings or the shard
# axis size changes between save and load, the same on-disk shape can hold
# differently aligned rows. These helpers stamp and verify the logical
# geometry in the checkpoint manifest.

def checkpoint_meta(*embeddings: ShardedEmbedding) -> dict:
    """Metadata dict for io.checkpoint.save_checkpoint(metadata=...)."""
    return {"sharded_embeddings": [
        {"num_embeddings": e.num_embeddings,
         "padded_vocab": e._padded_vocab(),
         "features": e.features} for e in embeddings]}


def validate_checkpoint_meta(metadata: dict,
                             *embeddings: ShardedEmbedding) -> None:
    """Raise if a checkpoint's embedding geometry mismatches the modules.
    Pass io.checkpoint.read_metadata(path). Checkpoints saved without
    the stamp validate trivially."""
    saved = (metadata or {}).get("sharded_embeddings")
    if saved is None:
        return
    if len(saved) != len(embeddings):
        raise ValueError(
            f"checkpoint has {len(saved)} sharded embeddings, model has "
            f"{len(embeddings)}")
    for i, (meta, emb) in enumerate(zip(saved, embeddings)):
        want = {"num_embeddings": emb.num_embeddings,
                "padded_vocab": emb._padded_vocab(),
                "features": emb.features}
        if meta != want:
            raise ValueError(
                f"sharded embedding {i} geometry changed since save: "
                f"checkpoint {meta} vs model {want}; padded rows would "
                "silently misalign — re-export the table instead")


__all__ = ["ShardedEmbedding", "checkpoint_meta", "embedding_rules",
           "shard_table", "validate_checkpoint_meta"]
