"""Sampled and factorized softmax layers for large vocabularies (port of
paddle_tpu/nn/sampled.py): `NCE` (noise-contrastive estimation, the
nce op) and `HierarchicalSigmoid` (the complete-binary-tree
hierarchical_sigmoid op). Neither builds the [B, V] logits in training;
`full_logits` / `full_log_probs` give the dense scores.

`NCE` draws its negatives from the `torch.Generator` that `forward`
takes (uniform ids, or `torch.multinomial` with replacement over
`probs`, JAX's `categorical`); the draws differ from JAX's.
`nce_loss` is the loss given the negatives, which both packages compute
alike. `HierarchicalSigmoid` keeps its path, bit and mask tables as
non-persistent buffers: they are built from `num_classes`, and are not
part of the model's JAX `state`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.nn import initializers as I


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0), with no large-x cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def nce_loss(x: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor, neg: torch.Tensor, num_classes: int,
             probs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example NCE loss given the negatives `neg` [B, K]: true class
    against K noise draws, each logit corrected by log(K q) for the
    noise distribution q (uniform, or `probs`)."""
    labels = labels.long()
    neg = neg.long()
    k = neg.shape[1]
    if probs is None:
        logq = -math.log(num_classes)
        logq_pos = torch.full(labels.shape, logq, device=x.device)
        logq_neg = torch.full(neg.shape, logq, device=x.device)
    else:
        logq_pos = torch.log(probs[labels] + 1e-12)
        logq_neg = torch.log(probs[neg] + 1e-12)
    pos_logit = torch.sum(x * weight[labels], dim=-1) + bias[labels]
    neg_logit = torch.einsum("bd,bkd->bk", x, weight[neg]) + bias[neg]
    pos_score = pos_logit - (math.log(float(k)) + logq_pos)
    neg_score = neg_logit - (math.log(float(k)) + logq_neg)
    return _softplus(-pos_score) + torch.sum(_softplus(neg_score), dim=-1)


class NCE(nn.Module):
    """Noise-contrastive estimation output layer: forward(x [B, D],
    labels [B], generator) -> per-example loss [B] over `num_neg`
    negatives a row. weight [V, D] (glorot-uniform), bias [V]."""

    def __init__(self, num_classes: int, features: int, num_neg: int = 16,
                 probs=None, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_neg = num_neg
        self.dtype = dtype
        self.weight = I.parameter(I.glorot_uniform, (num_classes, features),
                                  device)
        self.bias = I.parameter(I.zeros, (num_classes,), device)
        self.register_buffer(
            "probs", None if probs is None
            else torch.as_tensor(np.asarray(probs), dtype=torch.float32,
                                 device=device), persistent=False)

    def sample(self, batch: int, generator: torch.Generator
               ) -> torch.Tensor:
        """Negatives [batch, num_neg] drawn on the generator's device."""
        if self.probs is None:
            return torch.randint(0, self.num_classes, (batch, self.num_neg),
                                 generator=generator,
                                 device=generator.device)
        p = self.probs.to(generator.device)[None].expand(batch, -1)
        return torch.multinomial(p, self.num_neg, replacement=True,
                                 generator=generator)

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        """The loss over negatives drawn from `generator`."""
        neg = self.sample(x.shape[0], generator)
        return nce_loss(x, labels, self.weight.to(self.dtype),
                        self.bias.to(self.dtype), neg.to(x.device),
                        self.num_classes, self.probs)

    def full_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Dense [B, V] logits for inference."""
        return x @ self.weight.to(self.dtype).T + self.bias.to(self.dtype)


class HierarchicalSigmoid(nn.Module):
    """Complete-binary-tree hierarchical sigmoid: classes are the leaves
    of a tree over `num_classes - 1` internal nodes (leaf c at heap
    position c + num_classes); the loss sums the binary decisions on the
    root-to-leaf path (depth ceil(log2 V)). weight [V, D], bias [V]."""

    def __init__(self, num_classes: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.weight = I.parameter(I.glorot_uniform, (num_classes, features),
                                  device)
        self.bias = I.parameter(I.zeros, (num_classes,), device)
        depth = max(int(np.ceil(np.log2(max(num_classes, 2)))), 1)
        paths = np.zeros((num_classes, depth), np.int64)
        bits = np.zeros((num_classes, depth), np.float32)
        mask = np.zeros((num_classes, depth), np.float32)
        for c in range(num_classes):
            node = c + num_classes
            steps = []
            while node > 1:
                steps.append((node // 2, float(node % 2)))
                node //= 2
            steps.reverse()
            for d, (internal, bit) in enumerate(steps):
                paths[c, d] = internal - 1
                bits[c, d] = bit
                mask[c, d] = 1.0
        for name, arr in (("paths", paths), ("bits", bits), ("mask", mask)):
            self.register_buffer(name, torch.from_numpy(arr).to(device),
                                 persistent=False)

    def _wb(self):
        return self.weight.to(self.dtype), self.bias.to(self.dtype)

    def forward(self, x: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
        """Per-example negative log-likelihood [B]."""
        w, b = self._wb()
        labels = labels.long()
        nodes = self.paths[labels]
        logits = torch.einsum("bd,bkd->bk", x, w[nodes]) + b[nodes]
        nll = _softplus(torch.where(self.bits[labels] > 0, -logits, logits))
        return torch.sum(nll * self.mask[labels], dim=-1)

    def full_log_probs(self, x: torch.Tensor) -> torch.Tensor:
        """Dense [B, V] log-probabilities (inference)."""
        w, b = self._wb()
        node_logit = (x @ w.T + b)[:, self.paths]
        lp = -_softplus(torch.where(self.bits[None] > 0, -node_logit,
                                    node_logit))
        return torch.sum(lp * self.mask[None], dim=-1)
