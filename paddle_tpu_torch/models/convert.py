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
slot tree keyed like `params` (Adam's "m" and "v");
`load_jax_opt_state` reads that layout back into an optimizer.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.utils.tree import flatten_with_keys, nest


def _tensor(x) -> torch.Tensor:
    """A tensor as it is; numpy (read-only ones too) copied to one."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def param_path(name: str) -> str:
    """Port parameter (or buffer) name -> its path inside a JAX
    collection ('blocks.3.attn.q_proj.weight' ->
    'blocks_3/attn/q_proj/weight')."""
    return re.sub(r"\.(\d+)\.", r"_\1/", name).replace(".", "/")


def jax_path(name: str) -> str:
    """Port parameter name -> JAX variables path
    ('blocks.3.attn.q_proj.weight' -> 'params/blocks_3/attn/q_proj/weight')."""
    return "params/" + param_path(name)


def load_jax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX `variables` tree (numpy or tensor leaves) into
    `model`'s parameters in place; returns `model`. Parameters are stored
    float32, as JAX's param_dtype keeps them."""
    others = {k for k, v in tree.items() if k != "params" and v}
    if others:
        raise ValueError(f"collections other than params: {sorted(others)}")
    flat = dict(flatten_with_keys({"params": tree.get("params", {})}))
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
            param.copy_(_tensor(flat[path]))
    return model


def to_jax_params(model: nn.Module) -> Dict:
    """The model's parameters as a JAX `variables` tree of float32 numpy
    arrays: {"params": {...}} under the JAX paths."""
    return nest({jax_path(n): p.detach().float().cpu().numpy()
                 for n, p in model.named_parameters()})


def to_jax_opt_state(model: nn.Module, optimizer) -> Dict:
    """An optimizer's state in JAX's layout: {"step": int32, "slots":
    {slot: tree}}, each tree keyed like `variables["params"]`, one tree
    for each of the optimizer's `SLOTS` (the names JAX's `init_slots`
    gives). Slots a parameter has not made yet (before its first update)
    are its `init_slots` values."""
    slots = {}
    for slot in optimizer.SLOTS:
        flat = {}
        for n, p in model.named_parameters():
            st = optimizer.state.get(p) or optimizer.init_slots(p)
            flat[jax_path(n)] = st[slot].detach().float().cpu().numpy()
        slots[slot] = nest(flat)["params"]
    return {"step": np.int32(optimizer.step_count), "slots": slots}


def load_jax_opt_state(model: nn.Module, optimizer,
                       opt_state: Mapping) -> None:
    """The reverse of `to_jax_opt_state`: JAX's {"step", "slots"} (numpy
    or tensors) into the optimizer's slots, in place, and its
    `step_count`. Slot names, paths and shapes must match."""
    slots = opt_state.get("slots", {})
    if set(slots) != set(optimizer.SLOTS):
        raise KeyError(f"slots {sorted(slots)} != the optimizer's "
                       f"{sorted(optimizer.SLOTS)}")
    named = dict(model.named_parameters())
    with torch.no_grad():
        for slot, tree in slots.items():
            flat = dict(flatten_with_keys({"params": tree}))
            if set(flat) != {jax_path(n) for n in named}:
                raise KeyError(f"slot {slot}: parameter paths differ")
            for n, p in named.items():
                dst = optimizer.slots_of(p)[slot]
                src = _tensor(flat[jax_path(n)])
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"slot {slot} {jax_path(n)}: shape "
                                     f"{tuple(src.shape)} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
    optimizer.step_count = int(np.asarray(opt_state["step"]))
