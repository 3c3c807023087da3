"""QAT layers and the model rewriter (port of paddle_tpu/quant/layers.py).

`quantize_model` swaps every `Linear` / `Conv2D` of a module tree for
its Quant* twin in place. The twin keeps the float layer's parameter
tensors under their names, so a float checkpoint loads into the
quantized model and an optimizer built over either trains both; the one
new tensor is the activation scale, a persistent buffer `act_scale`
(JAX's `state` entry of that name, shape (), zeros until the first
training batch), moved in place only in training mode.

The rewrite converts by EXACT type, as JAX does (`type(m) is Conv2D`):
the port's `Conv3D` subclasses `Conv2D` (JAX's does not), and a
subclass is never converted.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from paddle_tpu_torch.nn.layers import Conv2D, Linear
from paddle_tpu_torch.quant.fake_quant import (fake_quant_channel_abs_max,
                                               fake_quant_moving_average)


def adopt(cls, layer: nn.Module) -> nn.Module:
    """An instance of `cls` holding `layer`'s attributes, parameters,
    buffers and children (the same tensors, in copies of its registries,
    so registering on the new layer leaves the old one as it was)."""
    new = cls.__new__(cls)
    new.__dict__.update({k: (v.copy() if isinstance(v, dict) else v)
                         for k, v in layer.__dict__.items()})
    return new


class _QuantMixin:
    """Per-channel weight fake quant and EMA activation fake quant, as
    the `_qtransform` hook of Linear / Conv2D."""

    def _setup(self, weight_bits: int, act_bits: int,
               momentum: float) -> None:
        self.weight_bits = weight_bits
        self.act_bits = act_bits
        self.momentum = momentum
        self.register_buffer("act_scale", torch.zeros(
            (), device=self.weight.device))

    @classmethod
    def from_float(cls, layer, weight_bits: int = 8, act_bits: int = 8):
        q = adopt(cls, layer)
        q._setup(weight_bits, act_bits, 0.9)
        return q

    def _qtransform(self, x: torch.Tensor, w: torch.Tensor):
        xq, new_scale = fake_quant_moving_average(
            x.float(), self.act_scale, self.act_bits, self.momentum,
            update=self.training)
        if self.training:
            with torch.no_grad():
                self.act_scale.copy_(new_scale)
        wq, _ = fake_quant_channel_abs_max(w.float(), self.weight_bits,
                                           axis=-1)
        return xq, wq


class QuantLinear(_QuantMixin, Linear):
    """Linear with per-channel weight fake quant and EMA activation fake
    quant (QAT). Same parameter names as Linear, plus `act_scale`."""

    def __init__(self, *args, weight_bits: int = 8, act_bits: int = 8,
                 momentum: float = 0.9, **kw):
        super().__init__(*args, **kw)
        self._setup(weight_bits, act_bits, momentum)


class QuantConv2D(_QuantMixin, Conv2D):
    """Conv2D with per-channel weight fake quant and EMA activation fake
    quant (QAT). Same parameter names as Conv2D, plus `act_scale`."""

    def __init__(self, *args, weight_bits: int = 8, act_bits: int = 8,
                 momentum: float = 0.9, **kw):
        super().__init__(*args, **kw)
        self._setup(weight_bits, act_bits, momentum)


def _convert(m: nn.Module, weight_bits: int, act_bits: int) -> nn.Module:
    if type(m) is Linear:
        return QuantLinear.from_float(m, weight_bits, act_bits)
    if type(m) is Conv2D:
        return QuantConv2D.from_float(m, weight_bits, act_bits)
    quantize_model(m, weight_bits, act_bits)
    return m


def swap_layers(module: nn.Module,
                convert: Callable[[nn.Module], nn.Module]) -> nn.Module:
    """In-place module-tree rewrite: `convert(m) -> m'` replaces every
    child module (an `nn.ModuleList`'s items are its children);
    converters recurse into containers themselves. The one walker behind
    `quantize_model` and `int8_compute.int8_compute_model`."""
    for name, child in list(module._modules.items()):
        if child is not None:
            module._modules[name] = convert(child)
    return module


def quantize_model(module: nn.Module, weight_bits: int = 8,
                   act_bits: int = 8) -> nn.Module:
    """In-place QAT rewrite of a module tree: every Linear / Conv2D
    becomes its Quant* twin; other modules are recursed into. Returns
    the same (mutated) module."""
    return swap_layers(module,
                       lambda m: _convert(m, weight_bits, act_bits))
