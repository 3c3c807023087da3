"""Carry a model's weights between the JAX package and the port.

`load_jax_params(model, tree)` takes the JAX `variables` as nested
dicts of numpy arrays (what `jax.device_get(variables)` gives; no JAX
needed here) and fills the port's parameters, and its persistent
buffers, by path. The transformers' paths:

    params/embed/weight                      [V, D]
    params/blocks_{i}/ln1|ln2/{scale,bias}   [D]
    params/blocks_{i}/attn/{q,k,v,out}_proj/{weight [in, out], bias}
    params/blocks_{i}/attn/qkv/{weight, bias}  (fused_qkv, head-major)
    params/blocks_{i}/ffn/{fc1,fc2}/{weight, bias}
    params/ln_f/{scale,bias}
    params/head/{weight,bias}                (untied head only)

The pipelined LMs' (parallel/pipeline.py; the stage stacks [S, ...],
sharded over pp on a mesh, carry as their whole leaves or a rank's
pieces of them, as any leaf):

    params/{embed [V, D], pos [max_len, D], lnf_s, lnf_b, head [D, V]}
    params/stages/{w_qkv [S, D, 3D] (head-major), w_o [S, D, D],
                   ln1_s, ln1_b, ln2_s, ln2_b [S, D],
                   w1 [S, D, F], b1, w2 [S, F, D], b2}     (PipelinedLM)
    params/stages/{gate [S, D, E], moe_w1 [S, E, D, F],
                   moe_w2 [S, E, F, D]}                  (PipelinedMoELM)

The vision, NLP and detection models' (same rule, JAX's list children
`name_{i}` being the port's `nn.ModuleList` items `name.{i}`):

    params/.../conv/weight                   [kh, kw, in/groups, out] (HWIO;
                                             3-D convs DHWIO), conv bias [out]
    params/.../bn/{scale,bias}               [C]
    state/.../bn/{mean,var}                  [C]   (BatchNorm running stats)
    state/.../{count [], sum [C], sumsq [C]}       (DataNorm totals)
    params/.../cell/{wx [D, 4H or 3H], wh, bias, wp}  (LSTM / GRU cells)

The port's module tree mirrors the JAX one and both keep Linear weights
as [in, out] and conv kernels as HWIO, so every tensor copies as it is.
The `state` collection maps onto the model's persistent buffers (its
`state_dict` minus its parameters) by the same path rule; non-persistent
buffers (position tables, the hierarchical sigmoid's path tables) are
not state. A missing or extra key (KeyError in `params`, ValueError in
`state`), a wrong shape, or a non-empty collection other than `params`
and `state` raises.

A frozen int8 layer (quant/int8_compute.py) carries its int8 `weight`
and f32 `w_scale` under `params` and, once calibrated, its `act_scale`
under `state`, both ways.

The reverse, `to_jax_params(model)`, gives the port's parameters as
such a tree (with `state` when the model has persistent buffers), and
`to_jax_opt_state(model, optimizer)` an optimizer's state in JAX's
layout: {"step": int32, "slots": {name: tree}} with each slot tree
keyed like `params` (Adam's "m" and "v"); `load_jax_opt_state` reads
that layout back into an optimizer.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.utils.tree import flatten_with_keys, nest


def to_tensor(x) -> torch.Tensor:
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


def persistent_buffers(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """The module's persistent buffers (its state_dict minus its
    parameters, tied ones under every alias): what JAX keeps in its
    `state` collection."""
    params = {id(p) for p in model.parameters()}
    return [(n, t) for n, t in model.state_dict(keep_vars=True).items()
            if id(t) not in params]


def _match(collection: str, flat: Dict, want: Dict) -> None:
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        if collection == "params":
            raise KeyError(f"parameter trees differ: missing {missing}, "
                           f"extra {extra}")
        raise ValueError(f"state trees differ (the model's persistent "
                         f"buffers): missing {missing}, extra {extra}")
    for path, t in want.items():
        arr = flat[path]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)} != "
                             f"{tuple(t.shape)}")
        if not t.is_floating_point() and to_tensor(arr).is_floating_point():
            raise ValueError(f"{path}: a floating leaf for the model's "
                             f"{t.dtype} tensor (an int8 layer's weight "
                             "loads only from int8)")


def load_jax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX `variables` tree (numpy or tensor leaves) into
    `model`'s parameters and persistent buffers in place; returns
    `model`. Parameters are stored float32, as JAX's param_dtype keeps
    them. A model with a `check_jax_tree(tree)` method may refuse a tree
    first (`BertEncoder` does)."""
    check = getattr(model, "check_jax_tree", None)
    if check is not None:       # a model's own refusal comes first
        check(tree)
    others = {k for k, v in tree.items() if k not in ("params", "state")
              and v}
    if others:
        raise ValueError(f"collections other than params and state: "
                         f"{sorted(others)}")
    todo = []
    for coll, named in (("params", list(model.named_parameters())),
                        ("state", persistent_buffers(model))):
        flat = dict(flatten_with_keys({coll: tree.get(coll) or {}}))
        want = {f"{coll}/{param_path(n)}": t for n, t in named}
        _match(coll, flat, want)
        todo += [(t, flat[path]) for path, t in want.items()]
    with torch.no_grad():
        for t, src in todo:
            t.copy_(to_tensor(src))
    return model


def _host(t: torch.Tensor) -> np.ndarray:
    """A parameter or buffer as numpy: float32 for a floating tensor,
    its own dtype otherwise (a frozen layer's int8 weight)."""
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def to_jax_params(model: nn.Module) -> Dict:
    """The model's parameters as a JAX `variables` tree of numpy arrays
    (float32, or a frozen int8 layer's int8 `weight`): {"params": {...}}
    under the JAX paths, and {"state": {...}} from its persistent
    buffers when it has any."""
    flat = {jax_path(n): _host(p) for n, p in model.named_parameters()}
    flat.update({"state/" + param_path(n): _host(b)
                 for n, b in persistent_buffers(model)})
    return {"params": {}, **nest(flat)}


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
                src = to_tensor(flat[jax_path(n)])
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"slot {slot} {jax_path(n)}: shape "
                                     f"{tuple(src.shape)} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
    optimizer.step_count = int(np.asarray(opt_state["step"]))
