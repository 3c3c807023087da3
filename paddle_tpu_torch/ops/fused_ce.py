"""Fused vocabulary projection + softmax cross-entropy, chunked over V
(port of paddle_tpu/ops/fused_ce.py).

The [N, V] logits never exist at once: the forward scans the padded
vocabulary in chunks with an online (running max, running sum of exp)
softmax state in float32, and the backward recomputes each chunk's
logits from the saved activations and the forward's log-sum-exp and
forms (softmax - onehot) * g one chunk at a time. The chunk products are
`torch.matmul`, as JAX left them to XLA. Padded vocabulary columns carry
a bias of -1e30, so exp() gives them exactly 0.

Numerics follow JAX: chunk logits and every accumulator are float32
(bf16 operands are widened, which is what XLA's float32 accumulation
computes), and the backward casts (softmax - onehot) * g to h's dtype
before its products. Hard labels only; `ignore_index` rows give zero
loss and zero gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["linear_cross_entropy", "effective_chunk", "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 8192  # default vocab tile width

_NEG = -1e30  # the bias of padded vocab columns: exp() == 0


def _num_chunks(v: int, chunk: int) -> int:
    return -(-v // chunk)


def effective_chunk(v: int, chunk: int = DEFAULT_CHUNK) -> int:
    """The vocab tile width linear_cross_entropy scans for a V-column
    classifier: `chunk` clamped to V rounded up to 256 (fused_ce.py:46)."""
    return min(chunk, _num_chunks(v, 256) * 256)


def _padded(w: torch.Tensor, b: Optional[torch.Tensor], v_pad: int):
    """float32 weight [D, v_pad] and bias [v_pad] (or None): padded
    columns are zero with a -1e30 bias."""
    v = w.shape[1]
    wf = w.float()
    bf = None if b is None else b.float()
    if v_pad == v:
        return wf, bf
    wf = F.pad(wf, (0, v_pad - v))
    bf = torch.zeros(v, device=w.device) if bf is None else bf
    return wf, F.pad(bf, (0, v_pad - v), value=_NEG)


def _chunk_logits(hf, wf, bf, i: int, chunk: int) -> torch.Tensor:
    """float32 logits of vocab chunk i: [N, chunk]."""
    logits = torch.matmul(hf, wf[:, i * chunk:(i + 1) * chunk])
    if bf is not None:
        logits = logits + bf[i * chunk:(i + 1) * chunk]
    return logits


class _LinearCrossEntropy(torch.autograd.Function):
    """`_lce` (fused_ce.py:109-182): per-row loss of softmax(h @ w + b)
    against hard labels, with its chunked backward."""

    @staticmethod
    def forward(ctx, h, w, b, labels, chunk: int, ignore_index: int):
        n = h.shape[0]
        nc = _num_chunks(w.shape[1], chunk)
        hf = h.float()
        wf, bf = _padded(w, b, nc * chunk)
        valid = labels != ignore_index
        safe = torch.where(valid, labels, 0).long()
        m = torch.full((n,), _NEG, device=h.device)
        s = torch.zeros(n, device=h.device)
        tgt = torch.zeros(n, device=h.device)
        for i in range(nc):
            logits = _chunk_logits(hf, wf, bf, i, chunk)
            nm = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - nm) + torch.exp(
                logits - nm[:, None]).sum(dim=1)
            loc = safe - i * chunk
            hit = (loc >= 0) & (loc < chunk)
            picked = logits.gather(1, loc.clamp(0, chunk - 1)[:, None])[:, 0]
            tgt = torch.where(hit, picked, tgt)
            m = nm
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w, b, safe, valid, lse)
        ctx.chunk = chunk
        return torch.where(valid, lse - tgt, 0.0)

    @staticmethod
    def backward(ctx, g):
        h, w, b, safe, valid, lse = ctx.saved_tensors
        chunk = ctx.chunk
        v = w.shape[1]
        nc = _num_chunks(v, chunk)
        hf = h.float()
        wf, bf = _padded(w, b, nc * chunk)
        gv = (g * valid).float()
        dh = torch.zeros(h.shape, device=h.device)
        dw = torch.zeros(wf.shape, device=h.device)
        dbs = []
        for i in range(nc):
            p = torch.exp(_chunk_logits(hf, wf, bf, i, chunk) - lse[:, None])
            loc = safe - i * chunk
            hit = (loc >= 0) & (loc < chunk)
            onehot = (F.one_hot(loc.clamp(0, chunk - 1), chunk).float()
                      * hit[:, None].float())
            dl = ((p - onehot) * gv[:, None]).to(h.dtype).float()
            cols = slice(i * chunk, (i + 1) * chunk)
            dh = dh + torch.matmul(dl, wf[:, cols].t())
            dw[:, cols] = torch.matmul(hf.t(), dl)
            dbs.append(dl.sum(dim=0))
        db = None if b is None else torch.cat(dbs)[:v].to(b.dtype)
        return (dh.to(h.dtype), dw[:, :v].to(w.dtype), db, None, None,
                None)


def linear_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                         labels: torch.Tensor,
                         b: Optional[torch.Tensor] = None, *,
                         chunk: int = DEFAULT_CHUNK,
                         ignore_index: int = -100) -> torch.Tensor:
    """Per-token CE of softmax(h @ w + b) against hard `labels`, without
    materializing the [N, V] logits (fused_ce.py:185).

    h [..., D]; w [D, V]; b [V] or None; labels [...] int. Returns the
    float32 loss shaped like `labels`. `chunk` is the vocab tile width
    (padded internally when V % chunk != 0)."""
    lead = labels.shape
    d = h.shape[-1]
    if h.shape[:-1] != lead:
        raise ValueError(f"h leading dims {tuple(h.shape[:-1])} != labels "
                         f"shape {tuple(lead)}")
    chunk = effective_chunk(w.shape[1], chunk)
    loss = _LinearCrossEntropy.apply(h.reshape(-1, d), w, b,
                                     labels.reshape(-1), chunk, ignore_index)
    return loss.reshape(lead)
