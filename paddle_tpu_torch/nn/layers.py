"""The dense layers the CausalLM needs (port of paddle_tpu/nn/layers.py).

Parameter layout and numerics follow the JAX layers so weights carry
across unchanged (models/convert.py):

- `Linear` keeps the `[in, out]` weight layout and computes
  `x @ w + b` in the layer's compute dtype (JAX `Linear.forward`).
- `Embedding` holds a `[V, D]` table; `attend` is the tied output head
  `x @ table.T`.
- `LayerNorm` computes in float32 with eps 1e-5 and returns the input
  dtype; its parameters are named `scale` and `bias` as in JAX.
- `Dropout` is the identity in eval mode and upscale-in-train dropout
  when training, drawing its bits from the `torch.Generator` the caller
  passes (never from PyTorch's global RNG).

Parameters are stored in float32, as JAX's `param_dtype` does, and are
cast to the compute dtype at each matmul.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Linear(nn.Module):
    """Fully-connected layer: y = x @ weight + bias, weight [in, out]."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(in_features, out_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if use_bias else None)
        # glorot_uniform, the JAX Linear's default initializer
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embedding(nn.Module):
    """Token lookup into a [V, D] table, plus the tied output head."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(num_embeddings, features, device=device))
        nn.init.normal_(self.weight, 0.0, 0.02)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """JAX's `jnp.take` in its default "fill" mode: ids in [-V, 0)
        count from the end, ids outside [-V, V) give a row of NaN. A
        clamped gather and a select, so a bad id neither raises nor
        syncs the host (on CUDA an out-of-range index is a device-side
        assert), and a NaN row sends no gradient to the table."""
        v = self.num_embeddings
        ids = torch.where(ids < 0, ids + v, ids)
        valid = (ids >= 0) & (ids < v)
        rows = self.weight[ids.clamp(0, v - 1)].to(self.dtype)
        return torch.where(valid[..., None], rows, float("nan"))

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-softmax projection: x @ table.T (LM output heads)."""
        return torch.matmul(x.to(self.dtype), self.weight.t().to(self.dtype))


class LayerNorm(nn.Module):
    """Layer normalisation over the last axis, computed in float32."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


class Dropout(nn.Module):
    """Identity in eval mode; upscale-in-train dropout when training
    (JAX Dropout, nn/layers.py:474): keep with probability 1 - rate and
    scale the kept values by 1 / (1 - rate). The keep bits come from
    `generator`, which training with rate > 0 requires (JAX's
    `cx.rng()`); the bits differ from JAX's bernoulli draw."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout in training needs a torch.Generator")
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))
