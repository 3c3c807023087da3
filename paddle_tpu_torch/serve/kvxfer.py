"""Fleet KV block transfer: ship host-tier blocks between replicas (port
of paddle_tpu/serve/kvxfer.py; the wire format is JAX's, so a replica of
either package pulls from one of the other).

The fleet prefix directory (serve/router.py /kvprefixes) can route a
REQUEST to warm KV, but until now the blocks themselves were pinned to
the replica that computed them — a request forced onto a different
replica (phase routing, failover, load) re-prefilled from scratch.
This module moves the blocks instead:

- SERVE. Every replica with a host tier exposes its content-keyed
  entries on `GET /kvblocks/<digest>` (serve/frontend.py). The body is
  one tier entry in the same npz encoding the tier's disk spill uses
  (engine/kvtier.py): a length-prefixed JSON manifest carrying the
  exact token key, layer/slot layout, dtypes and a crc32 over the npz
  bytes, then the npz itself. Blobs go out STILL ENCODED — fp entries
  stay bit-exact, int8 entries keep their original scales — so
  revival on the puller dequantizes identically to the source.
- PULL. When the router's plan finds the longest warm prefix on a
  replica OTHER than the routed target, it attaches transfer hints
  (`x-ptpu-kv-source`, `x-ptpu-kv-len`) instead of re-routing. The
  target's HTTP handler thread pulls every full-block prefix it is
  missing BEFORE enqueueing the request (`pull_prefix`), inserting the
  raw blobs into its own HostKVTier. Admission then revives them over
  the existing staged lane writes (PagedKVCache.alloc_sequence): the
  one step program is never rebuilt and the output is byte-identical
  to a local-warm hit.
- NEVER A WRONG ANSWER. Every blob is crc-checked AND its decoded
  token key is required to be an exact prefix of the incoming prompt
  (a digest collision or stale advertisement can only cost a pull,
  never poison the tier). Any failure — connect refused, black-holed
  socket, torn body, crc mismatch (resilience/chaos.py can inject all
  of these) — abandons the transfer, counts
  `ptpu_kvxfer_fallbacks_total`, and the request simply re-prefills.

Counters `ptpu_kvxfer_{blocks,bytes,pulls,fallbacks}_total` and the
`ptpu_kvxfer_pull_ms` histogram live on the engine registry, so the
transfer plane shows up in the same scrape as the tier it feeds
(OBSERVABILITY.md "Metric inventory").

Blob payloads are numpy only (the card's machine has no `ml_dtypes`): an
int8 entry records its dtype by name, and a bfloat16 fp block travels as
the tier keeps it, its raw 2-byte `|V2` payload (engine/kvtier.py). A
float32 or int8 blob decodes to the same entry in either package.
"""

from __future__ import annotations

import io
import json
import struct
import time
import zlib
from http.client import HTTPConnection
from typing import List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

import numpy as np

from paddle_tpu_torch.engine.kvtier import (HostKVTier, dtype_name,
                                           prefix_digest)
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.utils.log import serve_event

# wire envelope: 4-byte big-endian manifest length, manifest JSON,
# then the npz bytes the manifest's crc32 covers
_HDR = struct.Struct(">I")
_WIRE_VERSION = 1

DEFAULT_TIMEOUT_S = 5.0


class KVXferError(ValueError):
    """A blob failed to decode/verify (torn wire, crc mismatch, key or
    mode mismatch). Always caught inside pull_prefix — a transfer
    failure degrades to re-prefill, never surfaces to the client."""


class KVXferMetrics:
    """The transfer plane's series, registered on the engine registry
    (same story as the tier's own counters). All traffic counters —
    zeroed by the post-warmup reset like every other serve series."""

    def __init__(self, registry: MetricsRegistry):
        self.blocks = registry.counter(
            "ptpu_kvxfer_blocks_total",
            "Host-tier blocks pulled from a peer replica's /kvblocks")
        self.bytes = registry.counter(
            "ptpu_kvxfer_bytes_total",
            "Wire bytes of pulled KV blobs (envelope included)")
        self.pulls = registry.counter(
            "ptpu_kvxfer_pulls_total",
            "Transfer attempts (one per hinted request that was "
            "missing at least one block)")
        self.fallbacks = registry.counter(
            "ptpu_kvxfer_fallbacks_total",
            "Transfers abandoned to plain re-prefill (connect/stream "
            "failure, crc or key mismatch)")
        self.pull_ms = registry.histogram(
            "ptpu_kvxfer_pull_ms",
            "Wall latency of one pull_prefix transfer (all blocks)")


# -- wire encode/decode ------------------------------------------------------

def encode_entry(key: tuple, blobs: list, nbytes: int,
                 int8: bool) -> bytes:
    """Serialize one raw tier entry (as HostKVTier.entry_by_digest
    hands it over) into the wire envelope. Slot naming matches the
    disk spill's per-entry layout (`l{layer}_p{part}`)."""
    arrays = {}
    slots: List[str] = []
    dtypes: List[str] = []
    for j, blob in enumerate(blobs):
        if int8:
            kq, ks, vq, vs, dtype = blob
            parts = (kq, ks, vq, vs)
            dtypes.append(dtype_name(dtype))
        else:
            parts = blob
        for p, arr in enumerate(parts):
            slot = f"l{j}_p{p}"
            arrays[slot] = np.asarray(arr)
            slots.append(slot)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    npz = buf.getvalue()
    manifest = json.dumps({
        "version": _WIRE_VERSION, "int8": bool(int8),
        "crc32": zlib.crc32(npz),
        "key": [int(t) for t in key], "layers": len(blobs),
        "nbytes": int(nbytes), "slots": slots, "dtypes": dtypes,
    }).encode()
    return _HDR.pack(len(manifest)) + manifest + npz


def decode_entry(payload: bytes, int8: bool
                 ) -> Tuple[tuple, list, int]:
    """Parse + verify one wire envelope back into (key, blobs,
    nbytes), raising KVXferError on ANY defect. Mirrors the spill
    loader exactly: int8 scales come back as python floats and dtypes
    as their names, so dequantization is bit-identical to the source
    tier's own revival."""
    try:
        if len(payload) < _HDR.size:
            raise KVXferError("short envelope")
        (mlen,) = _HDR.unpack(payload[:_HDR.size])
        manifest_raw = payload[_HDR.size:_HDR.size + mlen]
        npz = payload[_HDR.size + mlen:]
        if len(manifest_raw) != mlen:
            raise KVXferError("torn manifest")
        manifest = json.loads(manifest_raw)
        if manifest.get("version") != _WIRE_VERSION:
            raise KVXferError(f"wire version {manifest.get('version')}")
        if bool(manifest.get("int8")) != bool(int8):
            raise KVXferError("int8 mode mismatch")
        if zlib.crc32(npz) != manifest.get("crc32"):
            raise KVXferError("crc mismatch")
        arrays = np.load(io.BytesIO(npz))
        key = tuple(int(t) for t in manifest["key"])
        blobs = []
        slots = iter(manifest["slots"])
        for j in range(int(manifest["layers"])):
            if int8:
                kq, ks, vq, vs = (arrays[next(slots)] for _ in range(4))
                blobs.append((kq, float(ks), vq, float(vs),
                              str(manifest["dtypes"][j])))
            else:
                blobs.append((arrays[next(slots)], arrays[next(slots)]))
        return key, blobs, int(manifest["nbytes"])
    except KVXferError:
        raise
    except (KeyError, ValueError, TypeError, OSError, struct.error,
            zlib.error, StopIteration, json.JSONDecodeError) as e:
        raise KVXferError(f"{type(e).__name__}: {e}") from e


def encode_tier_blob(tier: HostKVTier, digest: str) -> Optional[bytes]:
    """The /kvblocks/<digest> body for one advertised entry, or None
    when this tier doesn't hold it (the route 404s). Thread-safe:
    blob payloads are immutable, serialization runs outside the tier
    lock — HTTP handler threads serve this directly."""
    ent = tier.entry_by_digest(digest)
    if ent is None:
        return None
    key, blobs, nbytes = ent
    return encode_entry(key, blobs, nbytes, tier.int8)


# -- pull client -------------------------------------------------------------

def pull_prefix(tier: HostKVTier, source_url: str,
                tokens: Sequence[int], block_size: int,
                metrics: Optional[KVXferMetrics] = None,
                max_len: Optional[int] = None,
                timeout: float = DEFAULT_TIMEOUT_S) -> int:
    """Pull every full-block prefix of `tokens` that `source_url`
    holds and this tier is missing, shortest first (the revival walk
    in alloc_sequence is contiguous from the device match on). Runs on
    the serve front-end's HANDLER thread, before the request is
    enqueued — the engine loop never blocks on the network. Returns
    blocks inserted; NEVER raises — any failure counts a fallback and
    leaves the tier exactly as it was, so the caller just re-prefills.

    `max_len` (the router's x-ptpu-kv-len hint) caps how far past the
    prompt head to probe; without it the loop stops at the source's
    first 404."""
    bs = max(1, int(block_size))
    limit = len(tokens)
    if max_len is not None:
        limit = min(limit, int(max_len))
    wanted = [tuple(tokens[:end]) for end in range(bs, limit + 1, bs)]
    wanted = [k for k in wanted if not tier.contains(k)]
    if not wanted:
        return 0
    if metrics is not None:
        metrics.pulls.inc()
    t0 = time.monotonic()
    inserted = 0
    parts = urlsplit(source_url)
    try:
        for key in wanted:
            digest = prefix_digest(key)
            # one connection per block: the serve front-end speaks
            # HTTP/1.0 (close-delimited SSE), so sockets don't survive
            # across responses
            conn = HTTPConnection(parts.hostname, parts.port or 80,
                                  timeout=timeout)
            try:
                conn.request("GET", f"/kvblocks/{digest}")
                resp = conn.getresponse()
                body = resp.read()
                status = resp.status
            finally:
                conn.close()
            if status == 404:
                break           # source holds nothing longer: done
            if status != 200:
                raise KVXferError(f"source answered {status}")
            body = chaos.maybe_corrupt_kvxfer(body)
            got_key, blobs, nbytes = decode_entry(body, tier.int8)
            if got_key != key:
                # digest collision or a raced advertisement: the blob
                # is NOT the content we asked for — skip it, keep the
                # tier clean, and stop probing this source
                raise KVXferError("key mismatch (digest collision)")
            if tier.insert_encoded(got_key, blobs, nbytes):
                inserted += 1
                if metrics is not None:
                    metrics.blocks.inc()
                    metrics.bytes.inc(len(body))
    except (OSError, KVXferError) as e:
        if metrics is not None:
            metrics.fallbacks.inc()
        serve_event("kvxfer_fallback", source=source_url,
                    pulled=inserted, error=f"{type(e).__name__}: {e}")
    if metrics is not None:
        metrics.pull_ms.observe((time.monotonic() - t0) * 1e3)
    if inserted:
        serve_event("kvxfer_pull", source=source_url, blocks=inserted,
                    prefix_tokens=inserted * bs,
                    ms=round((time.monotonic() - t0) * 1e3, 3))
    return inserted
