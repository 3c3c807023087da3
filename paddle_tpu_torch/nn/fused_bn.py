"""Memory-efficient fused BatchNorm + ReLU for training (port of
paddle_tpu/nn/fused_bn.py, a `jax.custom_vjp` there and a
`torch.autograd.Function` here; no kernel of its own).

    z = gamma * x_hat + beta        (pre-ReLU output; SAVED)
    y = relu(z)                     (returned)
    backward: x_hat = (z - beta) / gamma   (valid at every position)
              relu mask = z > 0

Backward keeps only z and three [C] vectors (gamma, beta, inv): the BN
input x is never saved, and y is a free recompute from z. gamma is
clamped to |gamma| >= 1e-6 before the division, as JAX does, which
biases the gradient only in that measure-zero case. x_hat carries the
rounding of z's dtype (bf16 under bf16 training).

`BatchNorm(fuse_relu=True)` takes this path when training on batch
statistics with the features last, scale and center.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _fwd_math(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float):
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=axes)
    var = torch.clamp(xf.square().mean(dim=axes) - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps)
    z = ((xf - mean) * (inv * gamma) + beta).to(x.dtype)
    return torch.relu(z), z, mean, var, inv


class _BNReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, z, mean, var, inv = _fwd_math(x, gamma, beta, eps)
        ctx.save_for_backward(z, gamma, beta, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        z, gamma, beta, inv = ctx.saved_tensors
        zf = z.float()
        g = torch.where(zf > 0, dy.float(), torch.zeros_like(zf))
        tiny = gamma.abs() < 1e-6
        gamma_safe = torch.where(
            tiny, torch.where(gamma < 0, torch.full_like(gamma, -1e-6),
                              torch.full_like(gamma, 1e-6)), gamma)
        x_hat = (zf - beta) / gamma_safe
        axes = tuple(range(z.dim() - 1))
        n = 1
        for a in axes:
            n *= z.shape[a]
        dbeta = g.sum(dim=axes)
        dgamma = (g * x_hat).sum(dim=axes)
        dx = (gamma * inv) * (g - (x_hat * dgamma + dbeta) / n)
        return dx.to(z.dtype), dgamma, dbeta, None


def bn_relu_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """relu(batch_norm(x)) with the features last: x [..., C] (stats
    over every leading axis), gamma / beta [C] float32. Returns (y in
    x's dtype, mean [C] f32, var [C] f32); mean and var feed the running
    stats and carry no gradient."""
    return _BNReLU.apply(x, gamma, beta, eps)
