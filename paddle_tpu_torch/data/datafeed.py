"""Multi-slot DataFeed (port of paddle_tpu/data/datafeed.py): a native
threaded parser and a pure-Python one.

Capability-equivalent of PaddlePaddle Fluid's DataFeed tier
(paddle/fluid/framework/data_feed.cc `MultiSlotDataFeed`, configured by
data_feed.proto slot descriptors and consumed by the AsyncExecutor's
training threads): text files of slot-format lines are parsed off the
training thread into columnar batches.

As in the JAX package:
- slots are declared with a plain config string or a SlotSpec list
  instead of protobuf;
- sparse slots come back as (values, row-offsets) — CSR, the functional
  replacement for LoD — with `to_padded` producing the padded-ids +
  mask form of static shape that the models take;
- the native library (the port's own `datafeed.cc`) is built on demand
  with g++ by `utils/native.py` and bound with ctypes.

Line format, slots in config order: `<n> v1 .. vn <m> u1 .. um ...`
Dense slots must have n == dim; sparse slots vary per row.
`write_slot_file` writes the same bytes as the JAX package's for the
same examples, so a file written by either package feeds the other.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from paddle_tpu_torch.utils.native import LazyLib

__all__ = ["SlotSpec", "parse_config", "MultiSlotDataFeed",
           "write_slot_file", "to_padded"]


@dataclass(frozen=True)
class SlotSpec:
    name: str
    dtype: str = "int64"        # "int64" | "float"
    dense: bool = False
    dim: int = 1                # required width for dense slots

    def __post_init__(self):
        if self.dtype not in ("int64", "float"):
            raise ValueError(f"slot {self.name}: dtype must be int64|float")
        if self.dim < 1:
            raise ValueError(f"slot {self.name}: dim must be >= 1")


def parse_config(config: Union[str, Sequence[SlotSpec]]) -> List[SlotSpec]:
    """\"name:dtype:kind[:dim];...\" -> SlotSpec list (or pass specs through)."""
    if not isinstance(config, str):
        return list(config)
    slots = []
    for part in config.split(";"):
        part = part.strip()
        if not part:
            continue
        f = part.split(":")
        if len(f) < 3:
            raise ValueError(f"bad slot config {part!r}")
        slots.append(SlotSpec(f[0], f[1], f[2] == "dense",
                              int(f[3]) if len(f) > 3 else 1))
        if f[2] not in ("dense", "sparse"):
            raise ValueError(f"bad slot kind in {part!r}")
    if not slots:
        raise ValueError("empty slot config")
    return slots


def _config_str(slots: Sequence[SlotSpec]) -> str:
    return ";".join(
        f"{s.name}:{s.dtype}:{'dense' if s.dense else 'sparse'}:{s.dim}"
        for s in slots)


# ---------------------------------------------------------------- native lib
def _bind(lib: ctypes.CDLL) -> None:
    lib.df_open.restype = ctypes.c_void_p
    lib.df_open.argtypes = [ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.df_next.restype = ctypes.c_void_p
    lib.df_next.argtypes = [ctypes.c_void_p]
    lib.df_batch_rows.restype = ctypes.c_int
    lib.df_batch_rows.argtypes = [ctypes.c_void_p]
    lib.df_values.restype = ctypes.c_int64
    lib.df_values.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
    lib.df_lod.restype = ctypes.c_int64
    lib.df_lod.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))]
    lib.df_batch_free.restype = None
    lib.df_batch_free.argtypes = [ctypes.c_void_p]
    lib.df_error.restype = ctypes.c_char_p
    lib.df_error.argtypes = [ctypes.c_void_p]
    lib.df_close.restype = None
    lib.df_close.argtypes = [ctypes.c_void_p]


_lazy = LazyLib(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "datafeed.cc"),
    "libdatafeed.so", _bind, extra_flags=("-pthread",))


def _native() -> Optional[ctypes.CDLL]:
    return _lazy.get()


# Batch value type: dense slots -> [rows, dim] array; sparse slots ->
# (values [nnz], offsets [rows+1]) CSR pair.
Batch = Dict[str, Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]]


class MultiSlotDataFeed:
    """Iterate slot-format text files as columnar batches.

    `native=None` auto-selects the C++ parser when it builds, else the
    Python fallback; `native=True` raises (with g++'s output) when the
    library does not build; `native=False` parses in Python. Both yield
    the same rows in same-size batches (all full batches plus at most
    one tail); with nthreads > 1 the native path's batch composition
    and order vary across runs (files are claimed by whichever worker
    is free), with one thread they follow the file order.
    """

    def __init__(self, files: Sequence[str],
                 config: Union[str, Sequence[SlotSpec]],
                 batch_size: int = 128, nthreads: int = 2,
                 queue_cap: int = 8, native: Optional[bool] = None):
        self.files = [os.fspath(f) for f in files]
        if not self.files:
            raise ValueError("no input files")
        self.slots = parse_config(config)
        self.batch_size = int(batch_size)
        self.nthreads = int(nthreads)
        self.queue_cap = int(queue_cap)
        if native is True:
            self._lib = _lazy.require("datafeed")
        else:
            self._lib = _native() if native is None else None

    def __iter__(self) -> Iterator[Batch]:
        if self._lib is not None:
            yield from self._iter_native()
        else:
            yield from self._iter_python()

    # ------------------------------------------------------------- native
    def _iter_native(self) -> Iterator[Batch]:
        """Full batches stream straight through; each worker's end-of-file
        partial batch is held back and merged with the others so at most
        ONE tail batch (< batch_size rows) is emitted — same row set and
        batch size as the Python path (batch composition may differ with
        nthreads > 1 since file order is nondeterministic)."""
        lib = self._lib
        arr = (ctypes.c_char_p * len(self.files))(
            *[f.encode() for f in self.files])
        h = lib.df_open(_config_str(self.slots).encode(), arr,
                        len(self.files), self.nthreads, self.batch_size,
                        self.queue_cap)
        if not h:
            raise RuntimeError("df_open failed (bad config or files)")
        partials: List[Batch] = []
        try:
            while True:
                b = lib.df_next(h)
                if not b:
                    err = lib.df_error(h)
                    if err:
                        raise RuntimeError(
                            f"datafeed: {err.decode(errors='replace')}")
                    break
                try:
                    batch = self._convert_native(lib, h, b)
                    rows = lib.df_batch_rows(b)
                finally:
                    lib.df_batch_free(b)
                if rows == self.batch_size:
                    yield batch
                else:
                    partials.append(batch)
            if partials:
                merged = _merge_batches(partials, self.slots)
                yield from _split_batch(merged, self.slots, self.batch_size)
        finally:
            lib.df_close(h)

    def _convert_native(self, lib, h, b) -> Batch:
        rows = lib.df_batch_rows(b)
        out: Batch = {}
        for i, s in enumerate(self.slots):
            vp = ctypes.c_void_p()
            n = lib.df_values(h, b, i, ctypes.byref(vp))
            if n < 0:
                raise RuntimeError(f"datafeed: bad slot index {i}")
            ctype = ctypes.c_float if s.dtype == "float" else ctypes.c_int64
            np_dtype = np.float32 if s.dtype == "float" else np.int64
            if n == 0:
                vals = np.empty(0, np_dtype)
            else:
                vals = np.ctypeslib.as_array(
                    ctypes.cast(vp, ctypes.POINTER(ctype)), (n,)
                ).astype(np_dtype, copy=True)   # copy: freed with batch
            if s.dense:
                out[s.name] = vals.reshape(rows, s.dim)
            else:
                op = ctypes.POINTER(ctypes.c_int64)()
                m = lib.df_lod(h, b, i, ctypes.byref(op))
                offs = np.ctypeslib.as_array(op, (m,)).astype(
                    np.int64, copy=True)
                out[s.name] = (vals, offs)
        return out

    # ------------------------------------------------------------- python
    def _iter_python(self) -> Iterator[Batch]:
        rows: List[List[List[float]]] = []
        for path in self.files:
            with open(path) as fh:
                for lineno, line in enumerate(fh, 1):
                    toks = line.split()
                    if not toks:
                        continue
                    rows.append(self._parse_tokens(toks, path, lineno))
                    if len(rows) == self.batch_size:
                        yield self._assemble(rows)
                        rows = []
        if rows:
            yield self._assemble(rows)

    def _parse_tokens(self, toks, path, lineno):
        vals_per_slot = []
        k = 0
        try:
            for s in self.slots:
                n = int(toks[k]); k += 1
                if n < 0 or (s.dense and n != s.dim):
                    raise ValueError
                conv = float if s.dtype == "float" else int
                vals_per_slot.append([conv(t) for t in toks[k:k + n]])
                if len(vals_per_slot[-1]) != n:
                    raise ValueError
                k += n
            if k != len(toks):
                raise ValueError
        except (ValueError, IndexError):
            raise RuntimeError(
                f"datafeed: {path}:{lineno}: malformed slot line") from None
        return vals_per_slot

    def _assemble(self, rows) -> Batch:
        out: Batch = {}
        for i, s in enumerate(self.slots):
            np_dtype = np.float32 if s.dtype == "float" else np.int64
            per_row = [r[i] for r in rows]
            if s.dense:
                out[s.name] = np.asarray(per_row, np_dtype)
            else:
                vals = np.asarray(
                    [v for r in per_row for v in r], np_dtype)
                offs = np.zeros(len(rows) + 1, np.int64)
                np.cumsum([len(r) for r in per_row], out=offs[1:])
                out[s.name] = (vals, offs)
        return out


def _batch_rows(batch: Batch) -> int:
    v = next(iter(batch.values()))
    return len(v[1]) - 1 if isinstance(v, tuple) else v.shape[0]


def _merge_batches(batches: Sequence[Batch], slots) -> Batch:
    """Concatenate columnar batches rowwise (CSR offsets rebased)."""
    out: Batch = {}
    for s in slots:
        parts = [b[s.name] for b in batches]
        if s.dense:
            out[s.name] = np.concatenate(parts, axis=0)
        else:
            vals = np.concatenate([p[0] for p in parts])
            offs = [np.zeros(1, np.int64)]
            base = 0
            for p in parts:
                offs.append(p[1][1:] + base)
                base += p[1][-1]
            out[s.name] = (vals, np.concatenate(offs))
    return out


def _split_batch(batch: Batch, slots, batch_size: int) -> Iterator[Batch]:
    """Re-chunk a merged batch into batch_size pieces + one tail."""
    rows = _batch_rows(batch)
    for lo in range(0, rows, batch_size):
        hi = min(lo + batch_size, rows)
        piece: Batch = {}
        for s in slots:
            v = batch[s.name]
            if s.dense:
                piece[s.name] = v[lo:hi]
            else:
                vals, offs = v
                piece[s.name] = (vals[offs[lo]:offs[hi]],
                                 offs[lo:hi + 1] - offs[lo])
        yield piece


def write_slot_file(path: str, examples: Sequence[Sequence[Sequence]],
                    slots: Union[str, Sequence[SlotSpec]]) -> None:
    """Write examples (per example: one value-list per slot) as slot text."""
    specs = parse_config(slots)
    with open(path, "w") as fh:
        for ex in examples:
            if len(ex) != len(specs):
                raise ValueError("example arity != slot count")
            parts = []
            for vals, s in zip(ex, specs):
                if s.dense and len(vals) != s.dim:
                    raise ValueError(f"dense slot {s.name} needs {s.dim}")
                fmt = (lambda v: repr(float(v))) if s.dtype == "float" \
                    else (lambda v: str(int(v)))
                parts.append(" ".join([str(len(vals))] +
                                      [fmt(v) for v in vals]))
            fh.write(" ".join(parts) + "\n")


def to_padded(values: np.ndarray, offsets: np.ndarray, max_len: int,
              pad=0) -> Tuple[np.ndarray, np.ndarray]:
    """CSR -> (padded [rows, max_len], mask [rows, max_len]) — the
    static-shape form the models take (replaces LoD; over-length rows
    truncate). Vectorized: this sits on the training hot path
    (train_from_files)."""
    rows = len(offsets) - 1
    lens = np.minimum(np.diff(offsets), max_len)
    pos = np.arange(max_len)
    mask = pos[None, :] < lens[:, None]
    if len(values) == 0:
        return np.full((rows, max_len), pad, values.dtype), mask
    idx = np.minimum(offsets[:-1, None] + pos[None, :], len(values) - 1)
    padded = np.where(mask, values[idx], np.asarray(pad, values.dtype))
    return padded.astype(values.dtype), mask
