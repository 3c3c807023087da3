"""Model pruning (port of paddle_tpu/quant/prune.py).

Pruning is a tree-of-masks transform over trees in JAX's layout (the
nested dicts of `to_jax_params(model)["params"]` or
`Trainer.state().params`; numpy or tensor leaves), so path keys are
JAX's "/"-joined strings and a `{re.escape(path): ratio}` dict means the
same in both packages. Masks are computed from trained parameters
(global or per-layer magnitude) and applied as params * mask.
`masked_train_step` wraps the port's `Trainer.train_step`, which updates
the module in place, and re-masks the parameters after each step; as in
JAX the optimizer slots are not masked.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from paddle_tpu_torch.models.convert import param_path, to_tensor
from paddle_tpu_torch.utils.tree import (flatten_with_keys, map_leaves,
                                         unflatten_like)

Tree = Any


def _ndim(leaf) -> int:
    return leaf.dim() if isinstance(leaf, torch.Tensor) else np.ndim(leaf)


def _prunable(path: str, leaf, pattern: str) -> bool:
    return re.search(pattern, path) is not None and _ndim(leaf) >= 2


def magnitude_masks(params: Tree, ratio, pattern: str = r"weight$",
                    granularity: str = "element") -> Tree:
    """Binary keep-masks (float32 tensors) by weight magnitude.

    ratio: a float (the same sparsity everywhere) or {path-regex: float}
    (the first fully matching regex; 0 for unmatched paths).
    granularity: "element" (unstructured) or "channel" (whole output
    channels, the last dim, by their L2 norm). A mask keeps the k =
    max(int(size * (1 - r)), 1) largest, and every tie of the k-th.
    Non-prunable leaves get all-ones masks."""
    def ratio_for(path):
        if isinstance(ratio, dict):
            for pat, r in ratio.items():
                if re.fullmatch(pat, path):
                    return r
            return 0.0
        return ratio

    masks = []
    for path, leaf in flatten_with_keys(params):
        leaf = to_tensor(leaf)
        r = ratio_for(path)
        if not _prunable(path, leaf, pattern) or r <= 0.0:
            masks.append(torch.ones(leaf.shape, dtype=torch.float32,
                                    device=leaf.device))
            continue
        w = leaf.float()
        if granularity == "channel":
            norms = torch.sqrt(torch.sum(w.square(),
                                         dim=tuple(range(w.dim() - 1))))
            k = max(int(norms.shape[0] * (1.0 - r)), 1)
            thresh = torch.sort(norms).values[-k]
            keep = (norms >= thresh).float()
            masks.append(torch.broadcast_to(keep, leaf.shape))
        else:
            mag = w.abs().reshape(-1)
            k = max(int(mag.numel() * (1.0 - r)), 1)
            thresh = torch.sort(mag).values[-k]
            masks.append((w.abs() >= thresh).float())
    return unflatten_like(params, iter(masks))


def apply_masks(params: Tree, masks: Tree) -> Tree:
    """params * mask, keeping each leaf's dtype."""
    def mask(p, m):
        p = to_tensor(p)
        return p * to_tensor(m).to(p.dtype)
    return map_leaves(mask, params, masks)


def sparsity(masks: Tree, pattern: str = r"weight$") -> float:
    """Achieved sparsity over the prunable leaves."""
    total = kept = 0
    for path, m in flatten_with_keys(masks):
        if re.search(pattern, path) and _ndim(m) >= 2:
            m = to_tensor(m)
            total += m.numel()
            kept += float(torch.sum(m))
    return 1.0 - kept / total if total else 0.0


def masked_train_step(trainer, masks: Tree) -> Callable:
    """Wrap `trainer.train_step` so pruned weights stay pruned (the
    fine-tune-after-prune loop). Returns step(batch, generator=None) ->
    fetches; after each step every parameter is multiplied by its mask
    in place (`masks` keyed like `Trainer.state().params`)."""
    by_path = dict(flatten_with_keys(masks))

    def step(batch, generator=None):
        fetches = trainer.train_step(batch, generator)
        with torch.no_grad():
            for name, p in trainer.module.named_parameters():
                m = by_path.get(param_path(name))
                if m is not None:
                    p.mul_(to_tensor(m).to(device=p.device, dtype=p.dtype))
        return fetches
    return step


def sensitivity_analysis(eval_loss: Callable[[Tree], float], params: Tree,
                         ratios: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
                         pattern: str = r"weight$") -> Dict[str, Dict]:
    """Per-layer loss sensitivity: for each prunable leaf, prune ONLY it
    at each ratio and record `eval_loss(pruned params)`. Returns {path:
    {ratio: loss}} with the unpruned loss at ratio 0.0."""
    base = float(eval_loss(params))
    out: Dict[str, Dict] = {}
    for path, leaf in flatten_with_keys(params):
        if not _prunable(path, leaf, pattern):
            continue
        per = {0.0: base}
        for r in ratios:
            masks = magnitude_masks(params, {re.escape(path): r},
                                    pattern=pattern)
            per[float(r)] = float(eval_loss(apply_masks(params, masks)))
        out[path] = per
    return out


def select_ratios(sens: Dict[str, Dict], budget: float) -> Dict[str, float]:
    """Per-layer ratios: the largest ratio whose loss stays within
    `budget` of the unpruned loss (greedy per layer), keyed by the
    escaped path."""
    chosen = {}
    for path, per in sens.items():
        base = per[0.0]
        best = 0.0
        for r, loss in sorted(per.items()):
            if r > 0 and loss <= base + budget:
                best = max(best, r)
        chosen[re.escape(path)] = best
    return chosen
