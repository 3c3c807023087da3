"""Nested containers as JAX's pytrees flatten them, for the checkpoint
keys and the NaN/Inf guard's leaf names.

A tree is dicts, lists, tuples and dataclass instances (`TrainState`)
down to leaves (tensors, numpy arrays, Python scalars); `None` is an
empty subtree. The flattening order and keys are JAX's
(`jax.tree_util.tree_flatten_with_path` as paddle_tpu/io/checkpoint.py
joins it): a dict's children in sorted key order under their key, a
sequence's and a dataclass's children under their index, joined by
"/". So a `TrainState` flattens to `0/embed/weight`, `2/slots/m/...`,
`2/step` and `3`, the keys the JAX package writes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Mapping, Tuple


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return [(str(i), getattr(node, f.name))
            for i, f in enumerate(dataclasses.fields(node))]


def _is_node(node) -> bool:
    return (isinstance(node, (dict, list, tuple))
            or (dataclasses.is_dataclass(node)
                and not isinstance(node, type)))


def flatten_with_keys(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(key, leaf)] in JAX's order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(flatten_with_keys(child,
                                     f"{prefix}/{key}" if prefix else key))
    return out


def unflatten_like(target, leaves: Iterator):
    """A tree of `target`'s structure whose leaves are taken from
    `leaves` in flatten_with_keys order."""
    if target is None:
        return None
    if not _is_node(target):
        return next(leaves)
    if isinstance(target, dict):
        vals = {k: unflatten_like(target[k], leaves) for k in sorted(target)}
        return {k: vals[k] for k in target}
    children = [unflatten_like(v, leaves) for _, v in _children(target)]
    if isinstance(target, (list, tuple)):
        return type(target)(children)
    return type(target)(*children)


def nest(flat: Mapping[str, Any]) -> Dict:
    """{"a/b": x} -> {"a": {"b": x}}: flat "/"-joined keys as nested
    dicts."""
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        *heads, leaf = path.split("/")
        for key in heads:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def map_leaves(fn, tree, *rest):
    """A tree of `tree`'s structure with `fn(leaf, *rest_leaves)` at
    every leaf (as jax.tree.map; `rest` are trees of the same
    structure)."""
    others = [[leaf for _, leaf in flatten_with_keys(r)] for r in rest]
    return unflatten_like(tree, iter(
        [fn(leaf, *(o[i] for o in others))
         for i, (_, leaf) in enumerate(flatten_with_keys(tree))]))
