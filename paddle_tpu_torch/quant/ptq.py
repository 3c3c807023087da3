"""Post-training quantization: calibration and int8 weight storage (port
of paddle_tpu/quant/ptq.py).

`calibrate` rewrites a model to the QAT layers and runs its forward over
calibration batches in TRAINING mode, as JAX does (`training=True`), so
the activation-scale EMAs fill in; BatchNorm therefore normalises with
batch statistics and moves its running statistics too.

`quantize_weights`, `dequantize_weights` and `quantized_nbytes` work on
trees in JAX's layout, the nested dicts that `to_jax_params` or
`Trainer.state().params` give (numpy or tensor leaves), so that a
pattern picks the same leaves from the same "/"-joined paths in either
package. Their leaves come back as tensors.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.models.convert import (load_jax_params, to_jax_params,
                                             to_tensor)
from paddle_tpu_torch.quant.fake_quant import dequantize, quantize
from paddle_tpu_torch.quant.int8_compute import run_batches
from paddle_tpu_torch.quant.layers import quantize_model
from paddle_tpu_torch.utils.tree import (flatten_with_keys, map_leaves,
                                         unflatten_like)


def _merge(base: Dict, override: Mapping) -> Dict:
    out = dict(base)
    for k, v in override.items():
        out[k] = (_merge(base.get(k, {}), v)
                  if isinstance(v, Mapping) and isinstance(base.get(k), dict)
                  else v)
    return out


def load_merged(module: nn.Module, variables: Mapping) -> None:
    """Load a JAX-layout tree into `module` over its own tensors: what
    the tree holds wins, and what it lacks (a new `act_scale`) keeps the
    module's value (JAX's `_merge` of a fresh skeleton)."""
    load_jax_params(module, _merge(to_jax_params(module), variables))


def calibrate(module: nn.Module, variables, batches: Iterable[Any],
              weight_bits: int = 8, act_bits: int = 8
              ) -> Tuple[nn.Module, Dict]:
    """PTQ calibration: rewrite to the QAT layers (`quantize_model`),
    load `variables` when given (else keep the model's weights), then
    run the forward over `batches` in training mode with no optimizer so
    the EMA activation scales fill in. Returns (the quantized module,
    its tree in JAX's layout, the scales under `state`). An empty
    iterable raises ValueError."""
    qmodule = quantize_model(module, weight_bits, act_bits)
    if variables is not None:
        load_merged(qmodule, variables)
    n = run_batches(qmodule, batches, training=True)
    if n == 0:
        raise ValueError(
            "calibrate() got no calibration batches — activation scales "
            "cannot be collected from an empty iterable")
    return qmodule, to_jax_params(qmodule)


def quantize_weights(params, bits: int = 8,
                     pattern: str = r"(weight|kernel)$"):
    """Freeze weights to int8 storage: per-output-channel (last dim)
    abs-max scales. Returns (params with int8 leaves where the path
    matches `pattern` and the leaf has 2 or more dims, scales with the
    per-channel f32 scales there and 0.0 elsewhere)."""
    rx = re.compile(pattern)
    q_leaves, s_leaves = [], []
    for name, leaf in flatten_with_keys(params):
        leaf = to_tensor(leaf)
        if rx.search(name) and leaf.dim() >= 2:
            scale = leaf.abs().amax(dim=tuple(range(leaf.dim() - 1)))
            scale = scale.clamp_min(1e-12)
            q_leaves.append(quantize(leaf, scale, bits).to(torch.int8))
            s_leaves.append(scale)
        else:
            q_leaves.append(leaf)
            s_leaves.append(0.0)
    return (unflatten_like(params, iter(q_leaves)),
            unflatten_like(params, iter(s_leaves)))


def dequantize_weights(qparams, scales, bits: int = 8):
    """Inverse of quantize_weights (int8 storage -> f32 compute)."""
    def deq(q, s):
        q = to_tensor(q)
        return dequantize(q.float(), s, bits) if q.dtype == torch.int8 \
            else q
    return map_leaves(deq, qparams, scales)


def quantized_nbytes(params) -> int:
    """Bytes of every leaf of a tree (tensors or arrays)."""
    return sum(leaf.numel() * leaf.element_size()
               if isinstance(leaf, torch.Tensor) else np.asarray(leaf).nbytes
               for _, leaf in flatten_with_keys(params))
