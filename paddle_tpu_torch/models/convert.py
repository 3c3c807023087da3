"""Carry a CausalLM's weights between the JAX package and the port.

`load_jax_params(model, tree)` takes the JAX `variables` as nested
dicts of numpy arrays (what `jax.device_get(variables)` gives; no JAX
needed here) and fills the port's parameters by path:

    params/embed/weight                      [V, D]
    params/blocks_{i}/ln1|ln2/{scale,bias}   [D]
    params/blocks_{i}/attn/{q,k,v,out}_proj/{weight [in, out], bias}
    params/blocks_{i}/attn/qkv/{weight, bias}  (fused_qkv, head-major)
    params/blocks_{i}/ffn/{fc1,fc2}/{weight, bias}
    params/ln_f/{scale,bias}
    params/head/{weight,bias}                (untied head only)

The port's module tree mirrors the JAX one (`blocks.{i}` is JAX's
`blocks_{i}`), and both keep Linear weights as [in, out], so every
tensor copies as it is. A missing or extra key, a wrong shape, or a
non-empty collection other than `params` raises.

The reverse, `to_jax_params(model)`, gives the port's parameters as
such a tree, and `to_jax_opt_state(model, optimizer)` an optimizer's
state in JAX's layout: {"step": int32, "slots": {name: tree}} with each
slot tree keyed like `params` (Adam's "m" and "v").
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def jax_path(name: str) -> str:
    """Port parameter name -> JAX variables path
    ('blocks.3.attn.q_proj.weight' -> 'params/blocks_3/attn/q_proj/weight')."""
    return "params/" + re.sub(r"\.(\d+)\.", r"_\1/", name).replace(".", "/")


def load_jax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX `variables` tree into `model`'s parameters in place;
    returns `model`. Parameters are stored float32, as JAX's
    param_dtype keeps them."""
    others = {k for k, v in tree.items() if k != "params" and v}
    if others:
        raise ValueError(f"collections other than params: {sorted(others)}")
    flat = _flatten({"params": tree.get("params", {})})
    want = {jax_path(n): p for n, p in model.named_parameters()}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, "
                       f"extra {extra}")
    for path, param in want.items():
        arr = flat[path]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)} != "
                             f"{tuple(param.shape)}")
    with torch.no_grad():
        for path, param in want.items():
            param.copy_(torch.tensor(np.asarray(flat[path], np.float32)))
    return model


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        *heads, leaf = path.split("/")
        for key in heads:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def to_jax_params(model: nn.Module) -> Dict:
    """The model's parameters as a JAX `variables` tree of float32 numpy
    arrays: {"params": {...}} under the JAX paths."""
    return _unflatten({jax_path(n): p.detach().float().cpu().numpy()
                       for n, p in model.named_parameters()})


def to_jax_opt_state(model: nn.Module, optimizer) -> Dict:
    """An optimizer's state in JAX's layout: {"step": int32, "slots":
    {slot: tree}}, each tree keyed like `variables["params"]`. Slots a
    parameter has not created yet (before the first step) are zeros."""
    names = sorted({k for st in optimizer.state.values() for k in st})
    slots = {}
    for slot in names:
        flat = {}
        for n, p in model.named_parameters():
            st = optimizer.state.get(p, {})
            value = (st[slot] if slot in st
                     else torch.zeros(p.shape, dtype=torch.float32))
            flat[jax_path(n)] = value.detach().float().cpu().numpy()
        slots[slot] = _unflatten(flat)["params"]
    return {"step": np.int32(optimizer.step_count), "slots": slots}
