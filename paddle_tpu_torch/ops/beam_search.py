"""Beam search decoding (port of paddle_tpu/ops/beam_search.py).

The beam_search op's per-step top-k expansion with per-beam end-token
handling, then beam_search_decode's backtrack over the recorded parent
pointers. Shapes stay [batch, beams, ...]: a finished beam is frozen by
masking (only eos continues it, at no cost), as JAX keeps its static
shapes. JAX's `lax.scan` over positions is a Python loop here, and
`early_exit`'s `lax.while_loop` one that stops once every beam has
finished; both give the same tensors.

`decode_fn(tokens [B*K], pos, state) -> (logits [B*K, V], new_state)`
abstracts the model (`Transformer.decode_step` with its KV caches in
`state`). `state` is a tree of dicts, lists and tuples of tensors whose
leaves have leading dim B*K (`tile_beams` makes it from a per-sample
state).

Ties: `lax.top_k` and the final `jnp.argsort` break ties by the lower
index, and step 0 and finished beams are full of exact -1e9 ties, so
both are stable descending sorts here (never `torch.topk`).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from paddle_tpu_torch.utils.tree import flatten_with_keys, map_leaves

NEG_INF = -1e9


class BeamResult(NamedTuple):
    tokens: torch.Tensor      # [B, K, T] decoded ids (eos-padded), int32
    scores: torch.Tensor      # [B, K] total log-prob (length-normalised)
    lengths: torch.Tensor     # [B, K] int32


def _top(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: a stable descending sort, so equal
    values come lower index first."""
    idx = torch.sort(-x, dim=-1, stable=True)[1][..., :k]
    return torch.take_along_dim(x, idx, dim=-1), idx


def beam_search(decode_fn: Callable, init_state: Any, batch: int,
                beam_size: int, max_len: int, bos_id: int, eos_id: int,
                vocab_size: int, length_penalty: float = 0.0,
                early_exit: bool = False) -> BeamResult:
    """Run beam search from `init_state` (leaves of leading dim B*K).

    early_exit=True stops as soon as every beam has emitted eos instead
    of always running max_len positions; the outputs keep the
    [B, K, max_len] shape and equal the full run's."""
    device = _device_of(init_state)
    bk = batch * beam_size
    scores = torch.full((batch, beam_size), NEG_INF, dtype=torch.float32,
                        device=device)
    scores[:, 0] = 0.0
    tokens = torch.full((bk,), bos_id, dtype=torch.int32, device=device)
    finished = torch.zeros((batch, beam_size), dtype=torch.bool,
                           device=device)
    lengths = torch.zeros((batch, beam_size), dtype=torch.int32,
                          device=device)
    eos_only = torch.full((vocab_size,), NEG_INF, dtype=torch.float32,
                          device=device)
    eos_only[eos_id] = 0.0
    offsets = (torch.arange(batch, device=device)[:, None] * beam_size)
    # unwritten positions of an early-stopped decode keep eos tokens and
    # identity parents, so the backtrack below stays right
    tok_hist = torch.full((max_len, batch, beam_size), eos_id,
                          dtype=torch.int32, device=device)
    parent_hist = torch.arange(beam_size, device=device).repeat(
        max_len, batch, 1)
    state = init_state
    for pos in range(max_len):
        if early_exit and bool(finished.all()):
            break
        logits, state = decode_fn(tokens, pos, state)
        log_probs = torch.log_softmax(
            logits.reshape(batch, beam_size, vocab_size).float(), dim=-1)
        # finished beams: only eos continues, with zero added score
        log_probs = torch.where(finished[..., None], eos_only[None, None],
                                log_probs)
        cand = scores[..., None] + log_probs               # [B, K, V]
        scores, top_idx = _top(cand.reshape(batch, beam_size * vocab_size),
                               beam_size)
        parent = torch.div(top_idx, vocab_size, rounding_mode="floor")
        token = (top_idx % vocab_size).to(torch.int32)
        flat_parent = (parent + offsets).reshape(-1)
        state = map_leaves(lambda x: torch.index_select(x, 0, flat_parent),
                           state)
        was_fin = torch.take_along_dim(finished, parent, dim=1)
        parent_len = torch.take_along_dim(lengths, parent, dim=1)
        finished = was_fin | (token == eos_id)
        lengths = torch.where(was_fin, parent_len, parent_len + 1)
        tok_hist[pos] = token
        parent_hist[pos] = parent
        tokens = token.reshape(-1)

    # backtrack (beam_search_decode)
    beam_idx = torch.arange(beam_size, device=device).repeat(batch, 1)
    out = torch.empty((batch, beam_size, max_len), dtype=torch.int32,
                      device=device)
    for t in range(max_len - 1, -1, -1):
        out[..., t] = torch.take_along_dim(tok_hist[t], beam_idx, dim=1)
        beam_idx = torch.take_along_dim(parent_hist[t], beam_idx, dim=1)
    # pad after eos with eos
    pos = torch.arange(max_len, device=device)[None, None]
    out = torch.where(pos < lengths[..., None], out,
                      torch.full_like(out, eos_id))

    if length_penalty > 0:
        denom = ((5.0 + lengths.float()) / 6.0) ** length_penalty
        scores = scores / denom

    # sort beams by score (jnp.argsort(-scores): stable, ties lower first)
    order = torch.sort(-scores, dim=1, stable=True)[1]
    return BeamResult(
        tokens=torch.take_along_dim(out, order[..., None], dim=1),
        scores=torch.take_along_dim(scores, order, dim=1),
        lengths=torch.take_along_dim(lengths, order, dim=1))


def _device_of(tree) -> torch.device:
    for _, leaf in flatten_with_keys(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def tile_beams(tree: Any, beam_size: int) -> Any:
    """Repeat each leading-dim row beam_size times ([B,...] -> [B*K,...])."""
    return map_leaves(lambda x: torch.repeat_interleave(x, beam_size, dim=0),
                      tree)
