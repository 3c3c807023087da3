"""Sequence-lattice dynamic programs (port of paddle_tpu/ops/lattice.py):
the linear-chain CRF (forward algorithm, path score, NLL, Viterbi) and
CTC (loss and align).

Each is a Python loop over the time axis of batched tensor ops, lengths
handled by masking as in JAX's `lax.scan`; no step reads a value back
to the host. JAX's arithmetic is kept:

- CTC works with NEG_INF = -1e9, not -inf: an impossible alignment
  gives a large finite loss, and an empty label (`label_lengths == 0`)
  scores the all-blank path. `torch.nn.functional.ctc_loss` (inf for an
  impossible alignment, its own reductions, [T, B, V]) is not used. The
  recursion is JAX's, with each frame's alphas held relative to a
  running offset (`ctc_loss`'s docstring says why);
- `crf_decoding`'s max breaks ties by the lower tag, as `jnp.argmax`;
- `ctc_align` compacts the kept tokens by a scatter-add into unique
  slots (dropped tokens add 0 at the last slot).

Transition layout: transitions[0] start weights, [1] stop weights,
[2:] the [K, K] pairwise weights (from, to).
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e9


def _crf_unpack(transitions):
    return transitions[0], transitions[1], transitions[2:]


def _full_lengths(b: int, t: int, device) -> torch.Tensor:
    return torch.full((b,), t, dtype=torch.int64, device=device)


def crf_forward(emissions, transitions, lengths=None):
    """Log partition function [B] of a linear-chain CRF; emissions
    [B, T, K], transitions [K+2, K], lengths [B] or None."""
    t = emissions.shape[1]
    start, stop, pair = _crf_unpack(transitions)
    alpha = start[None, :] + emissions[:, 0]
    for pos in range(1, t):
        scores = alpha[:, :, None] + pair[None] + emissions[:, pos, None, :]
        new_alpha = torch.logsumexp(scores, dim=1)
        if lengths is not None:
            new_alpha = torch.where((pos < lengths)[:, None], new_alpha,
                                    alpha)
        alpha = new_alpha
    return torch.logsumexp(alpha + stop[None, :], dim=-1)


def crf_score(emissions, tags, transitions, lengths=None):
    """Score [B] of the tag path `tags` [B, T] (the likelihood's
    numerator)."""
    b, t, _ = emissions.shape
    start, stop, pair = _crf_unpack(transitions)
    tags = tags.long()
    if lengths is None:
        lengths = _full_lengths(b, t, emissions.device)
    lengths = lengths.long()
    pos = torch.arange(t, device=emissions.device)
    valid = pos[None, :] < lengths[:, None]
    unary = torch.gather(emissions, 2, tags[..., None])[..., 0]
    unary = torch.where(valid, unary, torch.zeros_like(unary)).sum(1)
    trans = pair[tags[:, :-1], tags[:, 1:]]
    trans = torch.where(valid[:, 1:], trans, torch.zeros_like(trans)).sum(1)
    last = torch.gather(tags, 1, (lengths - 1)[:, None])[:, 0]
    return unary + trans + start[tags[:, 0]] + stop[last]


def linear_chain_crf(emissions, tags, transitions, lengths=None):
    """Negative log-likelihood [B] of each tag path."""
    return crf_forward(emissions, transitions, lengths) \
        - crf_score(emissions, tags, transitions, lengths)


def crf_decoding(emissions, transitions, lengths=None):
    """Viterbi decode: (tags [B, T] int64, score [B]); positions past a
    row's length hold 0."""
    b, t, k = emissions.shape
    dev = emissions.device
    start, stop, pair = _crf_unpack(transitions)
    if lengths is None:
        lengths = _full_lengths(b, t, dev)
    ident = torch.arange(k, device=dev)[None, :].expand(b, k)
    delta = start[None, :] + emissions[:, 0]
    bps = []
    for pos in range(1, t):
        scores = delta[:, :, None] + pair[None]
        best, best_prev = torch.max(scores, dim=1)
        alive = (pos < lengths)[:, None]
        delta = torch.where(alive, best + emissions[:, pos], delta)
        bps.append(torch.where(alive, best_prev, ident))
    final = delta + stop[None, :]
    score, tag = torch.max(final, dim=-1)
    tags = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        tags.append(tag)
    tags = torch.stack(tags[::-1], dim=1)
    mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    return torch.where(mask, tags, torch.zeros_like(tags)), score


# ------------------------------------------------------------------- CTC

def ctc_loss(log_probs, labels, input_lengths=None, label_lengths=None,
             blank: int = 0):
    """CTC negative log-likelihood [B] (warpctc). log_probs [B, T, V]
    log-softmax outputs, labels [B, L] without blanks; lengths default
    to full. The alpha recursion over the blank-interleaved extended
    labels (length 2L+1) in log space.

    Each frame's alphas are kept relative to the row's running offset
    (the sum of each frame's max, taken as a constant): the recursion
    commutes with a shift, so the loss and its gradient are the
    unshifted recursion's, but float32 resolves alphas of size ~1
    instead of ~T * log V (at T 400 that is ~1e-6 against ~1e-4 in the
    gradient). NEG_INF stays -1e9 in absolute terms."""
    b, t, _ = log_probs.shape
    dev, dt = log_probs.device, log_probs.dtype
    l = labels.shape[1]
    s = 2 * l + 1
    labels = labels.long()
    if input_lengths is None:
        input_lengths = _full_lengths(b, t, dev)
    if label_lengths is None:
        label_lengths = _full_lengths(b, l, dev)
    label_lengths = label_lengths.long()

    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    pos = torch.arange(s, device=dev)
    ext_valid = pos[None, :] < (2 * label_lengths + 1)[:, None]
    skip_ok = torch.zeros((b, s), dtype=torch.bool, device=dev)
    skip_ok[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    neg = torch.full((b, 1), NEG_INF, dtype=dt, device=dev)

    # emissions of every extended symbol at every time: [B, T, S]
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(b, t, s))
    alpha = torch.cat([
        log_probs[:, 0, blank, None],
        torch.where(label_lengths > 0, emit[:, 0, 1], neg[:, 0])[:, None],
        neg.expand(b, s - 2)], dim=1)
    offset = torch.zeros((b, 1), dtype=dt, device=dev)
    for ti in range(1, t):
        floor = neg - offset                      # -1e9, absolute
        prev1 = torch.cat([floor, alpha[:, :-1]], dim=1)
        prev2 = torch.where(skip_ok, torch.cat(
            [floor.expand(b, 2), alpha[:, :-2]], dim=1), floor)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new_alpha = torch.where(ext_valid, merged + emit[:, ti], floor)
        shift = new_alpha.detach().amax(1, keepdim=True)
        alive = (ti < input_lengths)[:, None]
        alpha = torch.where(alive, new_alpha - shift, alpha)
        offset = torch.where(alive, offset + shift, offset)
    last = 2 * label_lengths
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1,
                          torch.clamp(last - 1, min=0)[:, None])[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, (neg - offset)[:, 0])
    return -(torch.logaddexp(a_last, a_prev) + offset[:, 0])


def ctc_align(tokens, lengths=None, blank: int = 0,
              pad_value: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse repeats, then remove blanks: tokens [B, T] -> (aligned
    [B, T] left-compacted and padded with `pad_value`, new lengths [B]
    int64)."""
    b, t = tokens.shape
    dev = tokens.device
    if lengths is None:
        lengths = _full_lengths(b, t, dev)
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=tokens.dtype, device=dev),
                      tokens[:, :-1]], dim=1)
    keep = valid & (tokens != blank) & (tokens != prev)
    new_len = keep.sum(1)
    target = torch.where(keep, torch.cumsum(keep, 1) - 1,
                         torch.full_like(new_len[:, None], t - 1))
    out = torch.zeros_like(tokens).scatter_add_(
        1, target, torch.where(keep, tokens, torch.zeros_like(tokens)))
    mask = torch.arange(t, device=dev)[None, :] < new_len[:, None]
    return torch.where(mask, out, torch.full_like(out, pad_value)), new_len
