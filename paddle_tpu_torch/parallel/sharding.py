"""Sharding rules: parameter path -> partition spec (port of
paddle_tpu/parallel/sharding.py).

The rule tables are the JAX package's, copied: (regex, spec) pairs over
'/'-joined parameter paths (the checkpoint notation), first match wins;
a spec entry is None (the dim is whole on every rank), an axis name, or
a tuple of axis names. A spec is a plain tuple here (JAX's
`PartitionSpec` is a tuple too).

JAX places a whole tree on a mesh and lets XLA partition it; a process
of the port is one rank, so `shard_variables` returns the rank's own
slices of a `variables` tree instead, and `shard_module` cuts a module's
parameters to those slices in place. A dim sharded over an axis of n
ranks is split into n equal contiguous parts, rank r taking part r, as a
`NamedSharding` lays it out.
"""

from __future__ import annotations

import re
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.utils.tree import flatten_with_keys, nest

Spec = Tuple


class ShardingRules:
    """Ordered (path-regex -> spec) table.

    Unmatched params fall back to `default`, or, when `fsdp_axis` is
    set, to ZeRO-style sharding of the largest dim of any parameter with
    prod(shape) >= fsdp_min_size and rank >= fsdp_min_rank."""

    def __init__(self, rules: Sequence[Tuple[str, Sequence]] = (),
                 default: Optional[Sequence] = None,
                 fsdp_axis: Optional[str] = None,
                 fsdp_min_size: int = 0, fsdp_min_rank: int = 1):
        self._rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
        self.default = tuple(default) if default is not None else None
        self.fsdp_axis = fsdp_axis
        self.fsdp_min_size = fsdp_min_size
        self.fsdp_min_rank = fsdp_min_rank

    def add(self, pattern: str, spec: Sequence) -> "ShardingRules":
        self._rules.append((re.compile(pattern), tuple(spec)))
        return self

    def spec_for(self, path: str, shape: Sequence[int]) -> Spec:
        for pat, spec in self._rules:
            if pat.search(path):
                return _fit_spec(spec, shape)
        if self.default is not None:
            return _fit_spec(self.default, shape)
        if (self.fsdp_axis is not None
                and len(shape) >= self.fsdp_min_rank
                and shape and int(np.prod(shape)) >= self.fsdp_min_size):
            entries: List = [None] * len(shape)
            entries[int(np.argmax(shape))] = self.fsdp_axis
            return tuple(entries)
        return ()

    def tree_specs(self, tree: Mapping) -> dict:
        """The spec of every leaf of a nested-dict tree, in its place."""
        return nest({path: self.spec_for(path, tuple(np.shape(leaf)))
                     for path, leaf in flatten_with_keys(tree)})


def _fit_spec(spec: Sequence, shape: Sequence[int]) -> Spec:
    """Trim/pad a spec to the rank of `shape` (trailing dims whole)."""
    spec = tuple(spec)[: len(shape)]
    return spec + (None,) * (len(shape) - len(spec))


def fsdp_rules(axis: str = "fsdp", min_size: int = 2 ** 16) -> ShardingRules:
    """ZeRO-style default: shard the largest dim of big params over
    `axis` (reference ReduceStrategy::kReduce, by dim)."""
    return ShardingRules(fsdp_axis=axis, fsdp_min_size=min_size)


def transformer_tp_rules(tp_axis: str = "tp",
                         fsdp_axis: Optional[str] = "fsdp") -> ShardingRules:
    """Megatron-style TP for the transformer family: attention qkv/out
    and mlp in/out projections split on the feature dim; embeddings
    split on vocab; everything else fsdp-sharded or whole."""
    return ShardingRules([
        (r"(q_proj|k_proj|v_proj|qkv|kv)/weight$", (None, tp_axis)),
        (r"(out_proj|o_proj)/weight$", (tp_axis, None)),
        (r"(fc1|w_in|up|gate)/weight$", (None, tp_axis)),
        (r"(fc2|w_out|down)/weight$", (tp_axis, None)),
        (r"embed[^/]*/weight$", (tp_axis, None)),
        (r"bias$", (None,)),
    ], fsdp_axis=fsdp_axis, fsdp_min_rank=2)


def serve_tp_rules(tp_axis: str = "tp") -> ShardingRules:
    """Megatron TP for the serving step (the engine's tp_size): q/k/v
    (or the head-major fused qkv) and fc1 column-parallel with their
    biases, out_proj and fc2 row-parallel with their biases whole (added
    once, after the reduce), embeddings, the head and the LayerNorms
    whole on every rank."""
    return ShardingRules([
        (r"(q_proj|k_proj|v_proj|qkv)/weight$", (None, tp_axis)),
        (r"(q_proj|k_proj|v_proj|qkv)/bias$", (tp_axis,)),
        (r"fc1/weight$", (None, tp_axis)),
        (r"fc1/bias$", (tp_axis,)),
        (r"(out_proj|fc2)/weight$", (tp_axis, None)),
    ], default=())


def _local_slices(spec: Spec, shape: Sequence[int], axis: str, rank: int,
                  size: int) -> Tuple[slice, ...]:
    """The index of rank `rank`'s part of a `shape` leaf under `spec`,
    counting only `axis` (any other axis name leaves its dim whole)."""
    idx = []
    for dim, entry in zip(shape, spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if axis not in names:
            idx.append(slice(None))
            continue
        if dim % size:
            raise ValueError(f"dim {dim} does not split over {size} ranks")
        part = dim // size
        idx.append(slice(rank * part, (rank + 1) * part))
    return tuple(idx) + (slice(None),) * (len(shape) - len(idx))


def shard_variables(tree: Mapping, rules: Optional[ShardingRules] = None,
                    rank: int = 0, size: int = 1,
                    axis: str = "tp") -> dict:
    """Rank `rank`'s slices (of `size` ranks on `axis`) of a `variables`
    tree of numpy arrays or tensors, under `rules` (whole by default).
    Leaves keep their type; sharded ones are contiguous copies."""
    rules = rules or ShardingRules()
    out = {}
    for path, leaf in flatten_with_keys(tree):
        shape = tuple(np.shape(leaf))
        idx = _local_slices(rules.spec_for(path, shape), shape, axis, rank,
                            size)
        part = leaf[idx]
        out[path] = (part.contiguous() if isinstance(part, torch.Tensor)
                     else np.ascontiguousarray(part))
    return nest(out)


def shard_module(module: torch.nn.Module, rules: ShardingRules, rank: int,
                 size: int, axis: str = "tp") -> torch.nn.Module:
    """Cut `module`'s parameters to rank `rank`'s slices in place, by
    their JAX paths (models/convert.param_path); returns `module`. A
    parameter the rules leave whole keeps its tensor."""
    from paddle_tpu_torch.models.convert import param_path

    with torch.no_grad():
        for name, p in module.named_parameters():
            shape = tuple(p.shape)
            idx = _local_slices(rules.spec_for(param_path(name), shape),
                                shape, axis, rank, size)
            if any(s != slice(None) for s in idx):
                p.data = p.data[idx].contiguous()
    return module


__all__ = ["ShardingRules", "fsdp_rules", "serve_tp_rules", "shard_module",
           "shard_variables", "transformer_tp_rules"]
