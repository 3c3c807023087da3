"""Length-bucketing for variable-length batches (the port's own copy of
paddle_tpu/data/bucketing.py, pure numpy).

Capability-equivalent of Paddle's ragged-batch machinery (LoD batching,
DynamicRNN's re-sort by length): samples are routed into a small set of
length buckets, each padded to its bucket boundary, so a step sees a
few batch shapes instead of one per batch (one CUDA graph or cuDNN plan
per shape), and padding waste is bounded by the bucket granularity.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np

Reader = Callable[[], Iterator[Any]]


def bucket_boundaries(max_len: int, min_len: int = 8,
                      growth: float = 1.5) -> List[int]:
    """Geometric bucket edges up to max_len (the standard seq2seq scheme:
    padding waste per bucket bounded by the growth factor)."""
    out, b = [], min_len
    while b < max_len:
        out.append(int(b))
        b = max(b * growth, b + 1)
    out.append(int(max_len))
    return out


def _default_len(sample) -> int:
    head = sample[0] if isinstance(sample, (tuple, list)) else sample
    return len(head)


def _pad_to(arr: np.ndarray, length: int, pad_value) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.ndim == 0 or arr.shape[0] >= length:
        return arr
    pad = [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=pad_value)


def bucket_by_length(reader: Reader, boundaries: Sequence[int],
                     batch_size: int,
                     len_fn: Optional[Callable[[Any], int]] = None,
                     pad_value=0,
                     pad_fields: Optional[Sequence[int]] = None,
                     drop_oversize: bool = True,
                     with_lengths: bool = True) -> Reader:
    """Reader decorator: emit batches of same-bucket samples, padded to the
    bucket boundary.

    Each emitted batch is a tuple of stacked numpy arrays (per field of the
    sample tuple); variable-length fields (`pad_fields`, default: all
    array-like fields whose leading dim varies) are padded to the bucket
    edge. With `with_lengths`, an int32 lengths array is appended — feed it
    to the masked ops (sequence_pool, sequence_softmax, static_rnn) that
    replace the reference's LoD-aware kernels.

    Leftover partial batches flush at end of stream (ragged tail batches
    keep the bucket shape; they are smaller only in batch dim).
    """
    len_fn = len_fn or _default_len
    bounds = sorted(boundaries)

    def bucketed():
        buckets: List[List[Any]] = [[] for _ in bounds]
        lens: List[List[int]] = [[] for _ in bounds]

        def flush(i):
            samples, ls = buckets[i], lens[i]
            if not samples:
                return None
            edge = bounds[i]
            is_tuple = isinstance(samples[0], (tuple, list))
            fields = len(samples[0]) if is_tuple else 1
            cols = []
            for f in range(fields):
                vals = [s[f] if is_tuple else s for s in samples]
                if pad_fields is None:
                    # A field is length-shaped (pad it) iff every sample's
                    # leading dim equals that sample's length — fixed-size
                    # side fields (dense features, labels) never match and
                    # keep their shape. Ambiguous cases (a fixed field whose
                    # dim coincides with every length) need explicit
                    # pad_fields.
                    arrs = [np.asarray(v) for v in vals]
                    do_pad = all(a.ndim > 0 for a in arrs) and all(
                        a.shape[0] == l for a, l in zip(arrs, ls))
                else:
                    do_pad = f in pad_fields
                if do_pad:
                    vals = [_pad_to(v, edge, pad_value) for v in vals]
                cols.append(np.stack([np.asarray(v) for v in vals]))
            if with_lengths:
                cols.append(np.asarray(ls, np.int32))
            buckets[i], lens[i] = [], []
            return tuple(cols)

        for sample in reader():
            n = len_fn(sample)
            idx = next((i for i, b in enumerate(bounds) if n <= b), None)
            if idx is None:
                if drop_oversize:
                    continue
                idx = len(bounds) - 1
                # truncate ragged fields to the last boundary
                edge = bounds[idx]
                if isinstance(sample, (tuple, list)):
                    sample = tuple(
                        np.asarray(v)[:edge]
                        if np.asarray(v).ndim > 0 else v for v in sample)
                else:
                    sample = np.asarray(sample)[:edge]
                n = edge
            buckets[idx].append(sample)
            lens[idx].append(n)
            if len(buckets[idx]) >= batch_size:
                yield flush(idx)
        for i in range(len(bounds)):
            out = flush(i)
            if out is not None:
                yield out

    return bucketed
