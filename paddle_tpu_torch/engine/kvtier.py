"""Host-RAM KV tier: the second tier behind PagedKVCache (port of
paddle_tpu/engine/kvtier.py).

The card's memory is the capacity wall of continuous batching: cached-
free prefix blocks die the moment the pool recycles them, and a
preempted sequence re-prefills its whole context. This module keeps
that KV alive one tier down:

- DEMOTION. When the pool is about to destroy cached content — a
  cached-free block handed out for fresh tokens, or a preempted
  sequence's committed blocks — the full block rows are copied to host
  arrays, keyed by the SAME content token tuple the prefix index uses
  (the key IS the content).
- REVIVAL. `PagedKVCache.alloc_sequence` walks a new prompt past its
  device-index match into this tier; every host hit claims a fresh
  device block and stages a (block, layers) load that the engine writes
  into the pools in place, in fixed lanes, BEFORE the step that reads
  them: a copy instead of a re-prefill.
- BUDGET. Entries live in an LRU ordered by last touch under a byte
  budget; demotions past the budget evict the coldest entries.
- INT8 MODE. `int8=True` stores blocks quantized with the JAX package's
  host abs-max scheme (quant/int8_compute.py: one scale per k/v array
  per layer per block), about half the bytes; revival dequantizes. fp
  mode round-trips bit for bit; the int8 tier is exact to within
  scale / 127 per element.

Host payloads are numpy arrays, as the JAX package's are: float32 and
float16 blocks as such, and a bfloat16 block — numpy has no bfloat16 —
as its raw 2-byte payload, a `|V2` array, which is what `np.savez`
writes for the JAX package's `ml_dtypes` bfloat16 arrays. `to_host` and
`to_torch` convert between a torch tensor and that form.

Spills (`spill` / `load_spill`) use the JAX package's layout (an npz of
every blob plus a json manifest with the npz's crc32), so a float32 or
int8 spill written by either package loads in the other.

The tier is thread-safe: payloads are immutable after insertion, and one
lock covers the entry map and the byte counter.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.obs.metrics import MetricsRegistry, default_registry
from paddle_tpu_torch.quant.int8_compute import (dequantize_host_int8,
                                                 quantize_host_int8)

# per-layer block payload as the cache hands it over / gets it back:
# [(k_block, v_block), ...] — one (block_size, Hkv, hd) pair per layer
BlockLayers = List[Tuple[np.ndarray, np.ndarray]]

_RAW_BF16 = np.dtype("V2")      # a bfloat16 payload, as np.savez stores it


def dtype_name(dtype) -> str:
    """The numpy name of a KV dtype ("float32", "bfloat16", ...), the
    form the spill manifest records; takes a torch dtype, a numpy dtype
    or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def to_host(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array: bfloat16 as its raw `|V2`
    payload (no copy; the caller owns `t`)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_RAW_BF16)
    return t.numpy()


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A host payload as a CPU tensor (a `|V2` array is bfloat16)."""
    if a.dtype == _RAW_BF16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _as_float32(a: np.ndarray) -> np.ndarray:
    return to_torch(a).float().numpy() if a.dtype == _RAW_BF16 \
        else np.asarray(a, np.float32)


def _dequantize(q: np.ndarray, scale: float, name: str) -> np.ndarray:
    """dequantize_host_int8 into the host form of dtype `name`: the
    bfloat16 cast is PyTorch's round-to-nearest-even, as ml_dtypes'."""
    if name == "bfloat16":
        x = dequantize_host_int8(q, scale, np.float32)
        return to_host(torch.from_numpy(x).to(torch.bfloat16))
    return dequantize_host_int8(q, scale, np.dtype(name))


def prefix_digest(tokens: Sequence[int]) -> str:
    """Stable 8-hex-digit digest of a token prefix: crc32 over the ids
    as little-endian u32, as the JAX package computes it. Used only to
    ADVERTISE a prefix (a collision can misroute, never corrupt: the
    receiving replica re-matches on exact tokens)."""
    raw = b"".join(int(t & 0xFFFFFFFF).to_bytes(4, "little")
                   for t in tokens)
    return format(zlib.crc32(raw), "08x")


class _Entry:
    """One demoted block: per-layer payloads + resident byte count.
    Payloads are immutable after construction, so readers may touch
    them outside the tier lock."""

    __slots__ = ("blobs", "nbytes")

    def __init__(self, blobs: list, nbytes: int):
        self.blobs = blobs
        self.nbytes = nbytes


class HostKVTier:
    """LRU byte-budgeted host store of full KV blocks, keyed by the
    prefix index's content token tuples. `int8=True` quantizes on
    demotion and dequantizes on revival."""

    def __init__(self, byte_budget: int, int8: bool = False,
                 registry: Optional[MetricsRegistry] = None):
        if byte_budget <= 0:
            raise ValueError(f"byte_budget {byte_budget} <= 0")
        self.byte_budget = int(byte_budget)
        self.int8 = bool(int8)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = \
            OrderedDict()                    # guarded-by: self._lock
        self._bytes = 0                      # guarded-by: self._lock
        self._warm_start_blocks = 0          # guarded-by: self._lock
        reg = registry if registry is not None else default_registry()
        self._c_demoted = reg.counter(
            "ptpu_kv_tier_demoted_blocks_total",
            "KV blocks copied out to the host tier",
            labelnames=("reason",))     # reason=evict|preempt|finish
        self._c_revived = reg.counter(
            "ptpu_kv_tier_revived_blocks_total",
            "Host-tier blocks revived into the device pool")
        self._c_revived_toks = reg.counter(
            "ptpu_kv_tier_revived_tokens_total",
            "Prompt tokens served from the host tier instead of "
            "re-prefill")
        self._c_lru = reg.counter(
            "ptpu_kv_tier_lru_evictions_total",
            "Host-tier entries dropped by the LRU byte budget")
        self._g_bytes = reg.gauge(
            "ptpu_kv_tier_bytes", "Host-tier resident bytes")
        self._g_entries = reg.gauge(
            "ptpu_kv_tier_entries", "Host-tier resident block entries")
        self._c_spill_saved = reg.counter(
            "ptpu_kv_tier_spill_saved_blocks_total",
            "Host-tier blocks spilled to disk at drain/interval")
        self._c_spill_loaded = reg.counter(
            "ptpu_kv_tier_spill_loaded_blocks_total",
            "Host-tier blocks warm-started from a disk spill at boot")
        self._g_spill_bytes = reg.gauge(
            "ptpu_kv_tier_spill_bytes",
            "On-disk size of the latest spill")

    # -- capacity ---------------------------------------------------------
    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def contains(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    # -- demotion ---------------------------------------------------------
    def put(self, key: tuple, layers: BlockLayers,
            reason: str = "evict") -> bool:
        """Store one full block's per-layer KV under `key`. Quantizes
        in int8 mode, charges the byte budget, and LRU-evicts the
        coldest entries while over it. Returns False when the single
        block exceeds the whole budget (nothing stored)."""
        blobs = []
        nbytes = 0
        for k, v in layers:
            k = np.asarray(k)
            v = np.asarray(v)
            if self.int8:
                kq, ks = quantize_host_int8(_as_float32(k))
                vq, vs = quantize_host_int8(_as_float32(v))
                name = "bfloat16" if k.dtype == _RAW_BF16 else k.dtype.name
                blobs.append((kq, ks, vq, vs, name))
                nbytes += kq.nbytes + vq.nbytes + 16
            else:
                blobs.append((k, v))
                nbytes += k.nbytes + v.nbytes
        if nbytes > self.byte_budget:
            return False
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True             # resident: touched, not counted
        self._insert_raw(key, blobs, nbytes)
        self._c_demoted.labels(reason=reason).inc()
        return True

    def put_device_int8(self, key: tuple, qlayers: list, dtype,
                        reason: str = "evict") -> bool:
        """Demote-to-host FAST PATH for a block already int8 on the card
        (the cache's compressed tier spilling its coldest entry):
        per-layer (kq, ks, vq, vs) payloads arrive quantized, and the
        content round-trips in ONE quant step total. An int8-mode tier
        stores them verbatim — revival dequantizes with the original
        device scales; an fp-mode tier stores the exact dequantization
        in `dtype` (the pool's)."""
        name = dtype_name(dtype)
        blobs = []
        nbytes = 0
        for kq, ks, vq, vs in qlayers:
            kq = np.asarray(kq)
            vq = np.asarray(vq)
            if self.int8:
                blobs.append((kq, float(ks), vq, float(vs), name))
                nbytes += kq.nbytes + vq.nbytes + 16
            else:
                k = _dequantize(kq, float(ks), name)
                v = _dequantize(vq, float(vs), name)
                blobs.append((k, v))
                nbytes += k.nbytes + v.nbytes
        if not self._insert_raw(key, blobs, nbytes):
            return False
        self._c_demoted.labels(reason=reason).inc()
        return True

    # -- revival ----------------------------------------------------------
    def get(self, key: tuple) -> Optional[BlockLayers]:
        """Per-layer (k, v) host arrays for a stored block (LRU touch),
        or None. The entry stays resident — one host copy can revive
        onto any number of device blocks over its lifetime."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._entries.move_to_end(key)
            blobs = entry.blobs
        if not self.int8:
            return list(blobs)
        return [(_dequantize(kq, ks, name), _dequantize(vq, vs, name))
                for kq, ks, vq, vs, name in blobs]

    def note_revived(self, blocks: int, tokens: int) -> None:
        """The cache revived `blocks` host blocks covering `tokens`
        prompt tokens at admission (telemetry only)."""
        if blocks:
            self._c_revived.inc(blocks)
        if tokens:
            self._c_revived_toks.inc(tokens)

    # -- fleet directory --------------------------------------------------
    def advertised(self, limit: int = 512) -> List[Tuple[int, str]]:
        """(prefix length, digest) for the most recently touched
        entries — what a replica publishes for a fleet prefix
        directory. Thread-safe."""
        with self._lock:
            keys = list(self._entries.keys())
        if limit and len(keys) > limit:
            keys = keys[-limit:]
        return [(len(k), prefix_digest(k)) for k in keys]

    def entry_by_digest(self, digest: str
                        ) -> Optional[Tuple[tuple, list, int]]:
        """Raw (key, blobs, nbytes) for the resident entry whose
        content digest matches, or None. Blobs come back still encoded
        (int8 stays int8) and immutable; the entry is NOT LRU-touched,
        so a fleet pull does not distort the local heat order. Newest
        entries win a digest collision."""
        with self._lock:
            for key in reversed(self._entries):
                if prefix_digest(key) == digest:
                    ent = self._entries[key]
                    return key, list(ent.blobs), ent.nbytes
        return None

    def insert_encoded(self, key: tuple, blobs: list, nbytes: int) -> bool:
        """Insert an entry that is ALREADY in this tier's blob encoding
        (a fleet KV-transfer pull): fp entries stay bit-exact and int8
        entries keep their original scales."""
        return self._insert_raw(key, blobs, nbytes)

    # -- warm restarts: disk spill ----------------------------------------
    # Layout inside the spill dir (tier-spill.json commits LAST, so a
    # manifest that exists implies a complete npz):
    #   tier-spill.npz    every blob array, named e{entry}_l{layer}_p{part}
    #   tier-spill.json   {"version", "int8", "crc32", "entries": [...]}

    _SPILL_NPZ = "tier-spill.npz"
    _SPILL_JSON = "tier-spill.json"

    def spill(self, dirpath: str) -> int:
        """Write every resident entry (LRU order preserved) to
        `dirpath`, atomically replacing any previous spill. Returns the
        number of blocks written."""
        with self._lock:
            snapshot = list(self._entries.items())
        os.makedirs(dirpath, exist_ok=True)
        arrays: dict = {}
        manifest_entries = []
        for i, (key, entry) in enumerate(snapshot):
            slots = []
            dtypes = []
            for j, blob in enumerate(entry.blobs):
                if self.int8:
                    kq, ks, vq, vs, dtype = blob
                    parts = (kq, ks, vq, vs)
                    dtypes.append(dtype_name(dtype))
                else:
                    parts = blob
                for p, arr in enumerate(parts):
                    slot = f"e{i}_l{j}_p{p}"
                    arrays[slot] = np.asarray(arr)
                    slots.append(slot)
            manifest_entries.append(
                {"key": [int(t) for t in key], "layers": len(entry.blobs),
                 "nbytes": entry.nbytes, "slots": slots, "dtypes": dtypes})
        # the tmp name keeps the .npz suffix (np.savez appends it)
        npz_tmp = os.path.join(dirpath, "tier-spill.tmp.npz")
        np.savez(npz_tmp, **arrays)
        with open(npz_tmp, "rb") as f:
            crc = zlib.crc32(f.read())
        os.replace(npz_tmp, os.path.join(dirpath, self._SPILL_NPZ))
        manifest = {"version": 1, "int8": self.int8, "crc32": crc,
                    "entries": manifest_entries}
        json_tmp = os.path.join(dirpath, self._SPILL_JSON + ".tmp")
        with open(json_tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(json_tmp, os.path.join(dirpath, self._SPILL_JSON))
        self._c_spill_saved.inc(len(snapshot))
        self._g_spill_bytes.set(float(
            os.path.getsize(os.path.join(dirpath, self._SPILL_NPZ))))
        return len(snapshot)

    def load_spill(self, dirpath: str) -> int:
        """Warm-start from a spill written by `spill()` (by either
        package): re-inserts every entry, oldest first, under the normal
        byte budget. A missing, torn, or mode-mismatched spill
        warm-starts NOTHING and returns 0. Returns blocks loaded."""
        manifest_path = os.path.join(dirpath, self._SPILL_JSON)
        npz_path = os.path.join(dirpath, self._SPILL_NPZ)
        if not (os.path.exists(manifest_path) and os.path.exists(npz_path)):
            return 0
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
            if manifest.get("version") != 1 \
                    or bool(manifest.get("int8")) != self.int8:
                return 0
            with open(npz_path, "rb") as f:
                if zlib.crc32(f.read()) != manifest.get("crc32"):
                    return 0
            arrays = np.load(npz_path)
            loaded = 0
            for ent in manifest["entries"]:
                key = tuple(int(t) for t in ent["key"])
                blobs = []
                slots = iter(ent["slots"])
                for j in range(ent["layers"]):
                    if self.int8:
                        kq, ks, vq, vs = (arrays[next(slots)]
                                          for _ in range(4))
                        # scales round-trip as 0-d float64 arrays; the
                        # python float put() stored keeps dequantize
                        # bit-exact against the tier before the restart
                        blobs.append((kq, float(ks), vq, float(vs),
                                      str(ent["dtypes"][j])))
                    else:
                        blobs.append((arrays[next(slots)],
                                      arrays[next(slots)]))
                if self._insert_raw(key, blobs, int(ent["nbytes"])):
                    loaded += 1
        except (OSError, KeyError, ValueError, json.JSONDecodeError,
                zlib.error, StopIteration):
            return 0
        if loaded:
            with self._lock:
                self._warm_start_blocks += loaded
            self._c_spill_loaded.inc(loaded)
        return loaded

    def republish_boot_state(self) -> None:
        """Re-publish the series that describe this tier's BOOT, not its
        traffic, after a registry reset (engine.reset_stats): the
        warm-start counter and the occupancy gauges."""
        with self._lock:
            bytes_now, count = self._bytes, len(self._entries)
            warm = self._warm_start_blocks
        if warm:
            self._c_spill_loaded.inc(warm)
        self._g_bytes.set(float(bytes_now))
        self._g_entries.set(float(count))

    def _insert_raw(self, key: tuple, blobs: list, nbytes: int) -> bool:
        """Insert an already-encoded entry: budget and LRU accounting, no
        re-quantization. A resident key is LRU-touched and kept."""
        if nbytes > self.byte_budget:
            return False
        lru_evicted = 0
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            self._entries[key] = _Entry(blobs, nbytes)
            self._bytes += nbytes
            while self._bytes > self.byte_budget:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                lru_evicted += 1
            bytes_now, count = self._bytes, len(self._entries)
        if lru_evicted:
            self._c_lru.inc(lru_evicted)
        self._g_bytes.set(float(bytes_now))
        self._g_entries.set(float(count))
        return True

    # -- observability ----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"tier_entries": len(self._entries),
                    "tier_bytes": self._bytes,
                    "tier_int8": self.int8}
