"""Parameter initializers (port of paddle_tpu/nn/initializers.py).

An initializer is `init(generator, shape, dtype) -> tensor`: the JAX
package's `init(rng, shape, dtype)` with a `torch.Generator` in place of
the key. `generator=None` draws from PyTorch's default CPU generator; a
given generator draws on its own device. The layers move the result to
their device. The draws differ from JAX's; the distributions, the fan
rule and the deterministic initializers are JAX's:

- `_fans` reads kernels in JAX's HWIO / DHWIO order (fan_in = in x
  receptive field, fan_out = out x receptive field), not PyTorch's OIHW
  rule;
- `truncated_normal` cuts a standard normal at +-2 before it scales;
- `bilinear` takes the filter's `f` from kw on both axes and writes it
  on the diagonal channels (kh, kw, in, out).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch


def _fans(shape: Sequence[int]) -> tuple:
    """(fan_in, fan_out): a scalar counts 1, a vector its length, a
    matrix [in, out], a kernel (..., in, out) times its receptive
    field."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive


def _device(generator: Optional[torch.Generator]) -> torch.device:
    return generator.device if generator is not None else torch.device("cpu")


def _uniform(generator, shape, low: float, high: float) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator,
                   device=_device(generator))
    return u * (high - low) + low


def _normal(generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator,
                       device=_device(generator))


def constant(value: float = 0.0):
    def init(generator, shape, dtype=torch.float32):
        return torch.full(tuple(shape), value, dtype=dtype,
                          device=_device(generator))
    return init


zeros = constant(0.0)
ones = constant(1.0)


def uniform(low: float = -1.0, high: float = 1.0):
    def init(generator, shape, dtype=torch.float32):
        return _uniform(generator, shape, low, high).to(dtype)
    return init


def normal(mean: float = 0.0, std: float = 1.0):
    def init(generator, shape, dtype=torch.float32):
        return (_normal(generator, shape) * std + mean).to(dtype)
    return init


def truncated_normal(mean: float = 0.0, std: float = 1.0):
    """A standard normal cut at +-2 (by inverting the CDF over the cut
    range, as jax.random.truncated_normal does), then scaled."""
    def init(generator, shape, dtype=torch.float32):
        lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
        u = _uniform(generator, shape, lo, hi)
        x = math.sqrt(2.0) * torch.erfinv(u)
        x = torch.clamp(x, -2.0, 2.0)
        return (x * std + mean).to(dtype)
    return init


def xavier(uniform_dist: bool = True, fan_in: int = None,
           fan_out: int = None):
    """Glorot init: U(-l, l), l = sqrt(6 / (fi + fo)), or N(0, 2 / (fi +
    fo))."""
    def init(generator, shape, dtype=torch.float32):
        fi, fo = _fans(shape)
        fi = fan_in if fan_in is not None else fi
        fo = fan_out if fan_out is not None else fo
        if uniform_dist:
            limit = math.sqrt(6.0 / (fi + fo))
            x = _uniform(generator, shape, -limit, limit)
        else:
            x = _normal(generator, shape) * math.sqrt(2.0 / (fi + fo))
        return x.to(dtype)
    return init


glorot_uniform = xavier(True)
glorot_normal = xavier(False)


def msra(uniform_dist: bool = False, fan_in: int = None):
    """Kaiming / He init: N(0, 2 / fi), or U(-l, l), l = sqrt(6 / fi)."""
    def init(generator, shape, dtype=torch.float32):
        fi, _ = _fans(shape)
        fi = fan_in if fan_in is not None else fi
        if uniform_dist:
            limit = math.sqrt(6.0 / fi)
            x = _uniform(generator, shape, -limit, limit)
        else:
            x = _normal(generator, shape) * math.sqrt(2.0 / fi)
        return x.to(dtype)
    return init


kaiming_normal = msra(False)


def bilinear():
    """Bilinear upsampling kernel for a transposed conv, (kh, kw, in,
    out): the filter on each diagonal channel pair, zeros elsewhere."""
    def init(generator, shape, dtype=torch.float32):
        kh, kw, cin, cout = shape
        f = math.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        w = np.zeros(shape, np.float32)
        og = np.ogrid[:kh, :kw]
        filt = (1 - abs(og[0] / f - c)) * (1 - abs(og[1] / f - c))
        for i in range(min(cin, cout)):
            w[:, :, i, i] = filt
        return torch.from_numpy(w).to(device=_device(generator), dtype=dtype)
    return init


def numpy_array(arr) -> Any:
    """Init from a concrete array; its shape must be the requested one."""
    def init(generator, shape, dtype=torch.float32):
        a = torch.as_tensor(np.asarray(arr)).to(device=_device(generator),
                                                dtype=dtype)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"numpy_array init shape {tuple(a.shape)} != "
                             f"{tuple(shape)}")
        return a
    return init


def orthogonal(scale: float = 1.0):
    """A (semi-)orthogonal [shape[0], prod(shape[1:])] matrix from the QR
    of a Gaussian, with the signs of R's diagonal folded in, reshaped."""
    def init(generator, shape, dtype=torch.float32):
        n_rows = shape[0]
        n_cols = int(np.prod(shape[1:]))
        mat = _normal(generator, (max(n_rows, n_cols), min(n_rows, n_cols)))
        q, r = torch.linalg.qr(mat)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if n_rows < n_cols:
            q = q.T
        return (scale * q[:n_rows, :n_cols]).reshape(tuple(shape)).to(dtype)
    return init


def parameter(init, shape: Sequence[int], device=None) -> torch.nn.Parameter:
    """A float32 parameter from `init` on the default generator, on
    `device` (what the port's layers call in `__init__`)."""
    return torch.nn.Parameter(
        init(None, tuple(shape), torch.float32).to(device))
