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
parameters to those slices in place. A dim sharded over axes of n ranks
in all is split into n equal contiguous parts, and the rank whose
coordinates on those axes ravel (first axis major) to k takes part k,
as a `NamedSharding` lays it out on JAX's device of the same rank.
`named_sharding(mesh, *spec)` is the counterpart of JAX's: the spec and
this rank's index of a leaf of a given shape.

Both take a mesh (`mesh=`, every axis at this rank's coordinates) or,
as the tensor-parallel engine calls them, one axis's `rank` and `size`.
"""

from __future__ import annotations

import re
import math
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


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def local_index(spec: Spec, shape: Sequence[int], coords: Mapping[str, int],
                sizes: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index of the part of a `shape` leaf under `spec` held at mesh
    coordinates `coords` (axis -> coordinate) of a mesh of `sizes`;
    axes missing from `sizes` leave their dim whole."""
    idx = []
    for dim, entry in zip(shape, spec):
        names = [a for a in _entry_axes(entry) if a in sizes]
        n = math.prod(sizes[a] for a in names)
        if n == 1:
            idx.append(slice(None))
            continue
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {n} ranks")
        k = 0
        for a in names:
            k = k * sizes[a] + coords[a]
        part = dim // n
        idx.append(slice(k * part, (k + 1) * part))
    return tuple(idx) + (slice(None),) * (len(shape) - len(idx))


def _mesh_view(mesh, rank: int, size: int, axis: str):
    """(coords, sizes) of a mesh's rank, or of one axis's rank."""
    if mesh is not None:
        return mesh.coords, mesh.shape
    return {axis: rank}, {axis: size}


class NamedSharding:
    """A leaf's placement on a mesh (the counterpart of JAX's
    NamedSharding): its `spec` and, for a leaf of a given shape, the
    `index` of the part this rank holds."""

    def __init__(self, mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = tuple(spec)

    def index(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        return local_index(_fit_spec(self.spec, shape), shape,
                           self.mesh.coords, self.mesh.shape)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(len(range(*s.indices(d)))
                     for s, d in zip(self.index(shape), shape))

    def __repr__(self) -> str:
        return f"NamedSharding(spec={self.spec})"


def named_sharding(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, spec)


class Piece:
    """One rank's part of a leaf of a sharded tree (what JAX's jax.Array
    carries in its addressable shard): `data`, the leaf's global
    `shape`, the `index` (slices) of `data` in it, and `owner`, whether
    this rank is the lowest of the ranks holding that part, the one that
    writes it to a checkpoint (JAX writes replica_id 0). A leaf of the
    tree utilities, not a node."""

    __slots__ = ("data", "shape", "index", "owner")

    def __init__(self, data, shape: Sequence[int], index: Tuple[slice, ...],
                 owner: bool = True):
        self.data = data
        self.shape = tuple(int(d) for d in shape)
        self.index = tuple(index)
        self.owner = owner

    def spans(self) -> List[List[int]]:
        """The index as [[start, stop], ...] per dim."""
        return [list(sl.indices(d)[:2]) for sl, d in zip(self.index,
                                                           self.shape)]

    def __repr__(self) -> str:
        return (f"Piece(shape={self.shape}, spans={self.spans()}, "
                f"owner={self.owner})")


class BatchSharding:
    """The batch placement of a mesh (the counterpart of JAX's
    batch_sharding): every leaf's leading dim split over the mesh's
    multi-rank batch `axes`, this rank's rows put on its device. With
    `accum` microbatches the global batch is read as [accum, B / accum]
    first, as JAX's step splits it, so this rank's microbatch i is its
    slice of the global microbatch i. Scalars are whole on every rank."""

    def __init__(self, mesh, axes: Sequence[str], accum: int = 1):
        self.mesh = mesh
        self.axes = mesh.wide(axes)
        self.accum = max(int(accum), 1)
        sizes, coords = mesh.shape, mesh.coords
        self.parts = math.prod(sizes[a] for a in self.axes)
        k = 0
        for a in self.axes:
            k = k * sizes[a] + coords[a]
        self.part = k

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def local(self, x):
        """This rank's rows of one host leaf (numpy or a tensor)."""
        if np.ndim(x) == 0 or (self.parts == 1 and self.accum == 1):
            return x
        b = x.shape[0]
        if b % (self.accum * self.parts):
            raise ValueError(f"batch dim {b} does not split into "
                             f"{self.accum} microbatches over "
                             f"{self.parts} ranks")
        m = b // (self.accum * self.parts)
        lead = x.reshape((self.accum, self.parts, m) + tuple(x.shape[1:]))
        part = lead[:, self.part].reshape((self.accum * m,)
                                          + tuple(x.shape[1:]))
        return (part.contiguous() if isinstance(part, torch.Tensor)
                else np.ascontiguousarray(part))


def shard_variables(tree: Mapping, rules: Optional[ShardingRules] = None,
                    rank: int = 0, size: int = 1, axis: str = "tp",
                    mesh=None) -> dict:
    """This rank's slices of a `variables` tree of numpy arrays or
    tensors under `rules` (whole by default): on `mesh` at its rank's
    coordinates, else rank `rank` of `size` on `axis`. Leaves keep their
    type; sharded ones are contiguous copies."""
    rules = rules or ShardingRules()
    coords, sizes = _mesh_view(mesh, rank, size, axis)
    out = {}
    for path, leaf in flatten_with_keys(tree):
        shape = tuple(np.shape(leaf))
        idx = local_index(rules.spec_for(path, shape), shape, coords, sizes)
        part = leaf[idx]
        out[path] = (part.contiguous() if isinstance(part, torch.Tensor)
                     else np.ascontiguousarray(part))
    return nest(out)


def shard_module(module: torch.nn.Module, rules: ShardingRules,
                 rank: int = 0, size: int = 1, axis: str = "tp",
                 mesh=None) -> torch.nn.Module:
    """Cut `module`'s parameters to this rank's slices in place, by their
    JAX paths (models/convert.param_path), on `mesh` or as rank `rank` of
    `size` on `axis`; returns `module`. A parameter the rules leave
    whole keeps its tensor."""
    from paddle_tpu_torch.models.convert import param_path

    coords, sizes = _mesh_view(mesh, rank, size, axis)
    with torch.no_grad():
        for name, p in module.named_parameters():
            shape = tuple(p.shape)
            idx = local_index(rules.spec_for(param_path(name), shape),
                              shape, coords, sizes)
            if any(s != slice(None) for s in idx):
                p.data = p.data[idx].contiguous()
    return module


__all__ = ["BatchSharding", "NamedSharding", "Piece", "ShardingRules", "fsdp_rules", "local_index",
           "named_sharding", "serve_tp_rules", "shard_module",
           "shard_variables", "transformer_tp_rules"]
