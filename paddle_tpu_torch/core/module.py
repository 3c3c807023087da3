"""The public helpers of paddle_tpu/core/module.py over `torch.nn.Module`.

JAX's `Module` holds no tensors and builds its `variables` tree on first
use; the port's modules are `torch.nn.Module`s that make their
parameters in `__init__` under the same names (models/convert.py maps
one to the other). What carries over is the error type, the counting
and naming of parameters, and `Sequential`.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple, Union

import torch
from torch import nn

from paddle_tpu_torch.models.convert import param_path
from paddle_tpu_torch.obs.goodput import param_count as obs_param_count


class ModuleError(Exception):
    pass


def param_count(model: Union[nn.Module, Mapping]) -> int:
    """Scalar count of a module's parameters (a tied table counted
    once), or of the `params` collection of a JAX-layout `variables`
    tree."""
    return obs_param_count(model if isinstance(model, nn.Module)
                           else model.get("params", {}))


def named_params(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """[(name, parameter)] under JAX's "a/b/c" names without `params/`
    ('blocks.3.attn.q_proj.weight' -> 'blocks_3/attn/q_proj/weight'), in
    the order JAX flattens its `params` tree (each level's keys
    sorted)."""
    named = [(param_path(n), p) for n, p in model.named_parameters()]
    return sorted(named, key=lambda kv: kv[0].split("/"))


class Sequential(nn.Module):
    """Chain of modules applied in order (fluid.nets style). Keyword
    arguments are accepted and ignored, as JAX's Sequential ignores
    them."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x, **kwargs):
        for layer in self.layers:
            x = layer(x)
        return x

