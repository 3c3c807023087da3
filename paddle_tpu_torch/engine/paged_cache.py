"""PagedKVCache: refcounted block-pool KV storage with prefix sharing
(port of paddle_tpu/engine/paged_cache.py).

Instead of one dense [B, Tmax, Hkv, hd] cache per batch slot, KV state
lives in ONE pool of fixed-size token blocks per layer
([num_blocks, block_size, Hkv, hd] for k and for v). A sequence owns a
BLOCK TABLE (ordered list of pool block ids); growing a sequence
appends a block from the free list, finishing/evicting one returns its
blocks in O(blocks).

Prefix sharing: blocks carry REFCOUNTS, and every FULL block whose KV
content is actually in the pool is registered in a prefix index keyed
by the exact token tuple of the sequence prefix it ends.
`alloc_sequence` walks a new prompt block by block through the index
and reuses matching blocks instead of allocating. The one legal write
into a shared block (a full-prompt hit is capped at n-1 so the last
token always recomputes for logits) triggers COPY-ON-WRITE: the writer
gets a fresh private block and the engine replays the old block's
contents into it on the device (`drain_copies`).

Freed blocks stay CACHED-FREE: when the last reference drops, the
block returns to the free list but keeps its prefix-index entry, so a
later request with the same prefix revives it. The entry is evicted
lazily, only when `_pop_free` hands the block out for fresh content.

In-device compressed tier: with `compress_blocks > 0` the cache also
owns a parallel int8 block pool plus per-block k/v scales
(`qpools`/`qscales`, slot 0 scratch like block 0). Cold committed
prefix blocks quantize into it — proactively while still fp-resident
(`compress_cold`: the fp copy and index entry stay, so fp hits stay
byte-exact), and as the first rung of the demotion ladder when the
pool recycles a cached-free block or a sequence preempts:
device-fp -> device-int8 -> host tier -> gone. A compressed entry
evicted to make room ships its int8 payload and scales into the host
tier (`host_tier`, engine/kvtier.py) without a second quantization, or
is dropped without one; either way it counts in `compress_spills`. A
prefix hit on a compressed entry is read IN PLACE
by default: the block table carries the bias-encoded slot -(slot+1)
and the step's mixed attention kernel dequantizes it. It claims an fp
block and stages a dequantize PROMOTION instead when `promote_hits`
says so, or when it is the prompt's final block (that block takes the
last token's write, and writes target fp blocks only). The quantize
and dequantize run as the engine's fixed-lane flushes.

Host tier (`host_tier`, engine/kvtier.py): content the pool is about to
destroy (a recycled cached-free block past the int8 rung, a preempted
sequence's committed blocks, a finished one's with the engine's
`demote_finished`) is copied to host arrays by a synchronous gather, so
the copy holds what the last step wrote before any later step can
overwrite the block. `alloc_sequence` walks a prompt past its device
and int8 matches into the tier; each host hit claims a fresh block and
stages a load (`drain_host_loads`) that the engine writes into the
pools in place before the step reads it.

Speculative decoding and n-best: `reserve_slots` reserves a decode
window of 1 + k slots all-or-nothing, and `fork_sequence` clones a
sequence onto shared blocks (and shared int8 slots) for parallel
sampling.

Host/device split: this class is the HOST-side allocator + bookkeeping.
The device-side pools are torch tensors in `self.pools`, allocated
with zeros (never torch.empty: masked attention lanes multiply p = 0
by V, and 0 * NaN from uninitialised memory would poison real rows)
and written IN PLACE by the engine's step and COW copies.

Block 0 is reserved as a scratch block: padded batch rows write their
garbage k/v there, so a dummy row can never corrupt a live sequence.

Tensor parallelism (`tp_size` > 1): the pools shard over kv heads, so
each rank's cache holds `pool_shape()` — Hkv/tp heads of every block —
for the fp and the int8 pools; the per-block int8 scales are whole on
every rank (the engine reduces a compressed block's scale over the
ranks with a MAX, so every rank quantizes with the scale of the whole
block). The bookkeeping runs on rank 0 only. What leaves the device for
the host tier is the GLOBAL block with every head: `gather_heads`,
which the tp engine sets, joins the ranks' head slices in head order,
so host-tier entries, spills and /kvblocks blobs have one layout at
any tp and in either package.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.engine.kvtier import HostKVTier, to_host
from paddle_tpu_torch.obs.metrics import MetricsRegistry, default_registry
from paddle_tpu_torch.quant.int8_compute import (block_scale,
                                                 dequantize_block,
                                                 quantize_block)

# a committed block untouched this many steps is cold enough for the
# proactive quantize sweep (compress_cold)
COMPRESS_IDLE_STEPS = 4


class CacheExhausted(Exception):
    """No free blocks; the scheduler must evict (preempt) a sequence."""


class PagedKVCache:
    """Refcounted block-pool KV cache shared by all layers of one model.

    All layers allocate in lockstep (a token occupies the same slot in
    every layer's pool), so ONE free list / block table set serves the
    whole stack; `pools` holds per-layer (k_pool, v_pool) tensors.
    """

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 enable_prefix_cache: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 host_tier: Optional[HostKVTier] = None,
                 compress_blocks: int = 0, promote_hits: int = 0,
                 tp_size: int = 1):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        if compress_blocks < 0:
            raise ValueError(f"compress_blocks {compress_blocks} < 0")
        if promote_hits < 0:
            raise ValueError(f"promote_hits {promote_hits} < 0")
        if tp_size < 1:
            raise ValueError(f"tp_size {tp_size} < 1")
        if num_kv_heads % tp_size != 0:
            # fail at construction, not as a reshape mid-serve: every
            # rank must own a whole number of kv heads (GQA groups stay
            # on one rank)
            raise ValueError(
                f"num_kv_heads={num_kv_heads} not divisible by "
                f"tp_size={tp_size}: the KV pool shards over kv-heads "
                "(pool_shape), so tp must divide them evenly")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.tp_size = tp_size
        self.device = resolve_device(device)
        self.enable_prefix_cache = enable_prefix_cache
        # (kind "fp"/"int8", block or slot, this rank's stacked host
        # slices [2L, bs, Hkv/tp, hd]) -> the global [2L, bs, Hkv, hd];
        # set by the tp engine, None on one rank
        self.gather_heads: Optional[Callable] = None
        shape = self.pool_shape()
        self.pools: List[Tuple[torch.Tensor, torch.Tensor]] = [
            (torch.zeros(shape, dtype=dtype, device=self.device),
             torch.zeros(shape, dtype=dtype, device=self.device))
            for _ in range(num_layers)]
        # the int8 tier: pools of compress_blocks + 1 slots (slot 0 is
        # scratch, which the fixed-lane flushes pad with) and per-slot
        # k/v scales, written in place by the engine's flushes. Zeros
        # and ones, like the fp pools: never uninitialised memory.
        self.compress_blocks = int(compress_blocks)
        self._compress_on = self.compress_blocks > 0 and enable_prefix_cache
        self.qpools: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.qscales: List[Tuple[torch.Tensor, torch.Tensor]] = []
        if self._compress_on:
            nq = self.compress_blocks + 1
            qshape = (nq,) + shape[1:]
            self.qpools = [
                (torch.zeros(qshape, dtype=torch.int8, device=self.device),
                 torch.zeros(qshape, dtype=torch.int8, device=self.device))
                for _ in range(num_layers)]
            self.qscales = [
                (torch.ones(nq, dtype=torch.float32, device=self.device),
                 torch.ones(nq, dtype=torch.float32, device=self.device))
                for _ in range(num_layers)]
        # compressed-tier bookkeeping (host-side): slot free list,
        # content-keyed LRU index (OrderedDict end = hottest), reverse
        # map, staged fixed-lane traffic, and the last-hit clock the
        # coldness policy orders by (the engine publishes step_now each
        # step)
        self._cfree = deque(range(1, self.compress_blocks + 1))
        self._cindex: "OrderedDict[tuple, int]" = OrderedDict()
        self._cslot_key: Dict[int, tuple] = {}
        self._pending_compress: List[Tuple[int, int]] = []  # (fp blk, slot)
        self._pending_promotes: List[Tuple[int, int]] = []  # (fp blk, slot)
        self._promote_slots: Set[int] = set()
        # direct reads: promote_hits 0 never promotes, 1 always promotes,
        # N > 1 promotes a key once it has been hit N times
        self.promote_hits = int(promote_hits)
        self._cslot_refs: Dict[int, int] = {}     # slot -> live direct readers
        self._chits: Dict[tuple, int] = {}        # key -> compressed-hit count
        self._last_hit: Dict[int, int] = {}       # block -> step
        self.step_now = 0
        self.compressed_total = 0         # blocks quantized in-device
        self.promoted_total = 0           # compressed blocks re-inflated
        self.compress_spills = 0          # cslot evictions (-> host/gone)
        self.compress_hit_tokens = 0      # prompt tokens served int8
        self.direct_reads = 0             # int8 blocks read in place
        self.direct_read_tokens = 0       # prompt tokens they covered
        # block 0 reserved for padded/dummy rows — never handed out
        self._free = deque(range(1, num_blocks))
        self._tables: Dict[int, List[int]] = {}
        self._lens: Dict[int, int] = {}
        # token ids backing each reserved position (the content identity
        # the prefix index is keyed on)
        self._tokens: Dict[int, List[int]] = {}
        # prefix length per sequence whose KV is actually IN the pool —
        # alloc reserves blocks for the whole prompt up front, but their
        # content arrives chunk by chunk; only committed-full blocks are
        # shareable
        self._committed: Dict[int, int] = {}
        self._refs: Dict[int, int] = {}               # block -> refcount
        # full-prefix token tuple -> block holding that prefix's last block
        self._index: Dict[tuple, int] = {}
        self._key_of: Dict[int, tuple] = {}           # block -> index key
        self._pending_copies: List[Tuple[int, int]] = []   # (src, dst)
        # optional host-RAM second tier: blocks the pool is about to
        # destroy are copied out, and alloc_sequence walks it past the
        # device index. Revivals stage (block, layers) loads here; the
        # engine writes them into the pools (drain_host_loads) BEFORE
        # any step reads or COW-copies them.
        self.host_tier = host_tier
        self._pending_host_loads: List[Tuple[int, list]] = []
        self.tier_revivals = 0            # host-tier blocks revived
        self.tier_hit_tokens = 0          # prompt tokens covered by them
        # cumulative stats
        self.hit_tokens = 0
        self.prompt_tokens = 0
        self.cow_copies = 0
        self.cached_free_evictions = 0    # stale prefix entries recycled
        self.cached_free_revivals = 0     # freed blocks re-hit from the index
        reg = registry if registry is not None else default_registry()
        self._c_cow = reg.counter(
            "ptpu_kv_cow_copies_total", "Copy-on-write block copies")
        self._c_evict = reg.counter(
            "ptpu_kv_cached_free_evictions_total",
            "Cached-free prefix entries evicted on block reuse")
        self._c_revive = reg.counter(
            "ptpu_kv_cached_free_revivals_total",
            "Freed blocks revived from the prefix index")
        self._c_prompt_toks = reg.counter(
            "ptpu_kv_prompt_tokens_total", "Prompt tokens admitted")
        self._c_hit_toks = reg.counter(
            "ptpu_kv_hit_tokens_total",
            "Prompt tokens served from the prefix cache")
        self._c_compress = reg.counter(
            "ptpu_kv_compress_total",
            "Cold prefix blocks quantized into the device int8 pool")
        self._c_promote = reg.counter(
            "ptpu_kv_promote_total",
            "Compressed blocks dequantized back into fp on a prefix hit")
        self._c_direct_reads = reg.counter(
            "ptpu_kv_direct_int8_reads_total",
            "Int8-resident blocks read in place by the ragged step")
        self._c_direct_toks = reg.counter(
            "ptpu_kv_direct_int8_tokens_total",
            "Prompt tokens served by direct int8 reads")

    # -- capacity ---------------------------------------------------------
    def pool_shape(self, tp_size: Optional[int] = None) -> Tuple[int, ...]:
        """The shape of one rank's k (or v) pool under `tp_size`-way
        tensor parallelism (default: this cache's own): the kv-head dim
        divides by tp, the others are whole. tp=1 is the global
        shape."""
        tp = self.tp_size if tp_size is None else tp_size
        if tp < 1 or self.num_kv_heads % tp != 0:
            raise ValueError(
                f"num_kv_heads={self.num_kv_heads} not divisible by "
                f"tp_size={tp}")
        return (self.num_blocks, self.block_size,
                self.num_kv_heads // tp, self.head_dim)

    def per_chip_pool_bytes(self) -> int:
        """Bytes one rank holds across every layer's k and v pool, read
        off the pool tensors this process allocated."""
        return sum(t.numel() * t.element_size()
                   for pair in self.pools for t in pair)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """DISTINCT allocated blocks — sharing shows up as lower usage."""
        return (self.num_blocks - 1) - len(self._free)

    @property
    def shared_blocks(self) -> int:
        return sum(1 for r in self._refs.values() if r > 1)

    @property
    def total_refs(self) -> int:
        return sum(self._refs.values())

    def ref_count(self, block: int) -> int:
        return self._refs.get(block, 0)

    def occupancy(self) -> float:
        """Fraction of allocatable blocks in use (serve_event metric)."""
        return self.used_blocks / max(1, self.num_blocks - 1)

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def _pop_free(self) -> int:
        """Take a block for FRESH content, lazily evicting any stale
        cached-free index entry it still carries (frees append to the
        RIGHT and this pops from the LEFT, so the longest-freed cached
        content is evicted first). With the int8 tier or a host tier
        attached, the content is demoted before the entry dies."""
        block = self._free.popleft()
        key = self._key_of.pop(block, None)
        if key is not None and self._index.get(key) == block:
            self._demote_block(block, key, "evict")
            del self._index[key]
            self.cached_free_evictions += 1
            self._c_evict.inc()
        self._last_hit.pop(block, None)
        return block

    def _demote_block(self, block: int, key: tuple, reason: str) -> bool:
        """Ship one committed block's KV one rung down the ladder —
        device-fp -> device-int8 -> host tier -> gone — under its content
        key. The int8 rung stages a fixed-lane quantize the engine
        flushes before anything overwrites the block; the host rung is a
        synchronous gather into the tier. reason="finish" skips the int8
        rung (finish demotion feeds the host tier). A no-op when a lower
        rung already holds the key: the key IS the content, so that copy
        is the truth."""
        if self._compress_on and reason != "finish":
            if key in self._cindex:
                return False          # already resident one rung down
            slot = self._take_cslot()
            if slot is not None:
                self._stage_compress(block, key, slot)
                return True
        if self.host_tier is None or self.host_tier.contains(key):
            return False
        return self.host_tier.put(key, self._block_layers(block),
                                  reason=reason)

    def _block_layers(self, block: int) -> list:
        """One block's per-layer (k, v) host arrays, gathered in one
        synchronous copy: it waits for every step already enqueued, so
        it holds the block's last written content."""
        host = torch.stack([t[block] for pair in self.pools
                            for t in pair]).cpu()
        if self.gather_heads is not None:
            host = self.gather_heads("fp", block, host)
        return [(to_host(host[2 * i]), to_host(host[2 * i + 1]))
                for i in range(len(self.pools))]

    # -- device lane traffic ----------------------------------------------
    # The engine's pre-step flushes, written in place over fixed-width
    # lanes of device index tensors. Every rank of a tp engine runs each
    # one on its own pool slices, in the leader's order.
    def copy_blocks(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """COW replay: dst blocks take src blocks' contents, every layer
        (index_select copies the sources out first, so a lane never reads
        a block another lane wrote); padding lanes are (0, 0)."""
        with torch.inference_mode():
            for kp, vp in self.pools:
                kp.index_copy_(0, dst, kp.index_select(0, src))
                vp.index_copy_(0, dst, vp.index_select(0, src))

    def _tier_pools(self):
        """(fp pool, int8 pool, scales) for every layer's k, then v."""
        for (kp, vp), (kq, vq), (ks, vs) in zip(self.pools, self.qpools,
                                                self.qscales):
            yield kp, kq, ks
            yield vp, vq, vs

    def compress_lanes(self, src: torch.Tensor, dst: torch.Tensor,
                       reduce_max: Optional[Callable] = None) -> None:
        """Quantize fp blocks `src` into int8 slots `dst`, every layer's
        k and v. `reduce_max` (a tp engine's: the MAX over the ranks of
        a [2L, lanes] tensor) makes each block's scale that of the whole
        block, so every rank quantizes its heads as one rank would."""
        with torch.inference_mode():
            tiers = list(self._tier_pools())
            blocks = [pool.index_select(0, src) for pool, _, _ in tiers]
            scales = torch.stack([block_scale(b) for b in blocks])
            if reduce_max is not None:
                scales = reduce_max(scales)
            for (_, qpool, qscales), b, sc in zip(tiers, blocks, scales):
                q8, sc = quantize_block(b, sc)
                qpool.index_copy_(0, dst, q8)
                qscales.index_copy_(0, dst, sc)

    def promote_lanes(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Dequantize int8 slots `src` into fp blocks `dst`."""
        with torch.inference_mode():
            for pool, qpool, qscales in self._tier_pools():
                pool.index_copy_(0, dst, dequantize_block(
                    qpool.index_select(0, src),
                    qscales.index_select(0, src), pool.dtype))

    def write_lanes(self, blocks: torch.Tensor,
                    payload: torch.Tensor) -> None:
        """Write `payload` [L, 2, lanes, bs, Hkv/tp, hd] (every layer's k
        and v, in the pools' dtype) into fp blocks `blocks`."""
        with torch.inference_mode():
            for li, (kp, vp) in enumerate(self.pools):
                kp.index_copy_(0, blocks, payload[li, 0])
                vp.index_copy_(0, blocks, payload[li, 1])

    # -- in-device compressed tier ----------------------------------------
    def _stage_compress(self, block: int, key: tuple, slot: int) -> None:
        """Queue one fp block's quantize into int8 slot `slot`. The
        payload is READ at flush time, which is safe against every
        same-plan writer: promotions and COW copies flush after
        compressions, and the step's scatters land after that."""
        self._pending_compress.append((block, slot))
        self._cindex[key] = slot           # inserted hottest (end)
        self._cslot_key[slot] = key
        self.compressed_total += 1
        self._c_compress.inc()

    def _take_cslot(self) -> Optional[int]:
        """A free int8 slot, or the coldest evictable compressed entry's
        slot after spilling that entry. Slots with in-flight traffic are
        not evictable: a pending-compress dst holds no payload yet, a
        pending-promote src is about to be read, and a slot with live
        direct readers is part of a running sequence's table. None when
        nothing can move."""
        if self._cfree:
            return self._cfree.popleft()
        busy = {s for _, s in self._pending_compress}
        busy |= self._promote_slots
        busy |= set(self._cslot_refs)
        for key, slot in self._cindex.items():     # coldest first
            if slot in busy:
                continue
            self._spill_cslot(key, slot)
            del self._cindex[key]
            del self._cslot_key[slot]
            self._chits.pop(key, None)   # warm-up clock dies with the entry
            return slot
        return None

    def _spill_cslot(self, key: tuple, slot: int) -> None:
        """An evicted compressed entry leaves the device: its int8
        payload and scales ship straight into the host tier — one quant
        step total, never a dequantize-requantize round trip (an int8
        tier stores them verbatim, an fp tier their exact
        dequantization). Without a host tier the entry is dropped."""
        self.compress_spills += 1
        if self.host_tier is None or self.host_tier.contains(key):
            return
        self.host_tier.put_device_int8(key, self._slot_qlayers(slot),
                                       self.dtype, reason="evict")

    def _slot_qlayers(self, slot: int) -> list:
        """One int8 slot's per-layer (kq, kscale, vq, vscale) payload,
        the tier's device-int8 encoding, in one synchronous copy each of
        the ints and the scales."""
        q = torch.stack([t[slot] for pair in self.qpools
                         for t in pair]).cpu()
        if self.gather_heads is not None:
            q = self.gather_heads("int8", slot, q)
        s = torch.stack([t[slot] for pair in self.qscales
                         for t in pair]).cpu().tolist()
        return [(q[2 * i].numpy(), s[2 * i], q[2 * i + 1].numpy(),
                 s[2 * i + 1]) for i in range(len(self.qpools))]

    def compress_cold(self) -> int:
        """Proactive cold sweep (engine-driven, once per step): quantize
        the coldest committed prefix blocks — cached-free AND
        refcount-shared — into FREE int8 slots. Coldness is LRU by
        last-hit step; a block must have sat untouched >=
        COMPRESS_IDLE_STEPS.
        The fp copy and its index entry STAY (committed full blocks are
        content-immutable), so fp hits remain byte-exact. It never
        spills a compressed entry to make room. Returns blocks
        staged."""
        if not self._compress_on or not self._cfree:
            return 0
        # a staged host-load or promote dst holds no real content until
        # its flush, which runs after the quantize lanes
        inflight = {b for b, _ in self._pending_host_loads}
        inflight |= {b for b, _ in self._pending_promotes}
        cands = sorted(
            (self._last_hit.get(b, 0), b)
            for b, key in self._key_of.items()
            if key not in self._cindex and b not in inflight
            and self.step_now - self._last_hit.get(b, 0)
            >= COMPRESS_IDLE_STEPS)
        staged = 0
        for _, b in cands:
            if not self._cfree:
                break
            self._stage_compress(b, self._key_of[b], self._cfree.popleft())
            staged += 1
        return staged

    def demote_sequence(self, seq_id: int, reason: str = "preempt") -> int:
        """Copy a live sequence's committed full blocks one rung down —
        the preemption path (the scheduler calls this right before
        free_sequence, so re-admission reads, promotes or revives them
        instead of re-prefilling) and, with reason="finish", the
        engine's `demote_finished` path into the host tier. Returns
        blocks demoted."""
        if (self.host_tier is None and not self._compress_on) \
                or not self.enable_prefix_cache:
            return 0
        table = self._tables.get(seq_id)
        if table is None:
            return 0
        self._register_full_blocks(seq_id)
        toks = self._tokens[seq_id]
        bs = self.block_size
        count = 0
        for bi in range(self._committed.get(seq_id, 0) // bs):
            b = table[bi]
            if b < 0:
                # direct-read entry: the content already lives in the
                # int8 tier, so preempt demotion is a no-op; finish
                # demotion ships the int8 payload to the host tier
                slot = -b - 1
                key = (self._cslot_key.get(slot)
                       or tuple(toks[:(bi + 1) * bs]))
                if reason == "finish" and self.host_tier is not None \
                        and not self.host_tier.contains(key):
                    if self.host_tier.put_device_int8(
                            key, self._slot_qlayers(slot), self.dtype,
                            reason=reason):
                        count += 1
                continue
            key = self._key_of.get(b) or tuple(toks[:(bi + 1) * bs])
            if self._demote_block(b, key, reason):
                count += 1
        return count

    def _match_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Longest run of committed full blocks matching `tokens`' head
        (read-only: no refs taken)."""
        if not self.enable_prefix_cache:
            return []
        matched: List[int] = []
        bs = self.block_size
        for end in range(bs, len(tokens) + 1, bs):
            block = self._index.get(tuple(tokens[:end]))
            if block is None:
                break
            matched.append(block)
        return matched

    def can_allocate(self, tokens) -> bool:
        """Admission check. `tokens` may be a token list (prefix-aware:
        matched blocks cost nothing beyond their own revival) or a bare
        count (conservative)."""
        if isinstance(tokens, int):
            return self.blocks_for(tokens) <= len(self._free)
        matched = self._match_prefix(tokens)
        need = self.blocks_for(len(tokens)) - len(matched)
        # cached-free matches leave the free list too (revival)
        revive = sum(1 for b in matched if b not in self._refs)
        return need + revive <= len(self._free)

    # -- sequence lifecycle ----------------------------------------------
    def alloc_sequence(self, seq_id: int, tokens: Sequence[int],
                       count_stats: bool = True) -> int:
        """Reserve blocks for a sequence's prompt, reusing committed
        prefix blocks from the index and, past them, the int8 tier and
        then the host tier.
        Returns the number of CACHED tokens (KV already on the device —
        the engine prefills only the suffix). A full-prompt hit is
        capped at n-1 so the last token always recomputes (its logits
        seed sampling); that write lands inside a shared block and COWs
        it. Raises CacheExhausted (allocating nothing) when the free
        list is short. `count_stats=False` leaves hit_tokens/
        prompt_tokens untouched: a preemption re-admission re-hits its
        own just-committed blocks and would otherwise inflate
        hit_rate."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        n = len(tokens)
        bs = self.block_size
        matched = self._match_prefix(tokens)
        # walk PAST the fp match into the int8 tier. A hit is read in
        # place (bias-encoded slot in the table) unless promote_hits says
        # to promote it, or it is the prompt's FINAL block, whose write
        # (the capped last token) must land in a writable fp block
        chits: List[Tuple[tuple, int, bool]] = []   # (key, slot, promote?)
        if self._compress_on:
            for end in range((len(matched) + 1) * bs, n + 1, bs):
                key = tuple(tokens[:end])
                slot = self._cindex.get(key)
                if slot is None:
                    break
                hits = self._chits.get(key, 0) + 1
                chits.append((key, slot,
                              end >= n or 0 < self.promote_hits <= hits))
        # ... and past THAT into the host tier: every hit's payload is
        # fetched now, so a later LRU eviction between admission and
        # the flush cannot revoke it
        host_loads: List[Tuple[tuple, list]] = []
        if self.host_tier is not None and self.enable_prefix_cache:
            for end in range((len(matched) + len(chits) + 1) * bs,
                             n + 1, bs):
                layers = self.host_tier.get(tuple(tokens[:end]))
                if layers is None:
                    break
                host_loads.append((tuple(tokens[:end]), layers))
        n_direct = sum(1 for _, _, p in chits if not p)
        need = self.blocks_for(n) - len(matched) - n_direct
        revive = [b for b in matched if b not in self._refs]
        if need + len(revive) > len(self._free):
            raise CacheExhausted(
                f"need {need + len(revive)} blocks, {len(self._free)} free")
        for b in matched:
            if b in self._refs:
                self._refs[b] += 1
            else:                       # cached-free hit: revive the block
                self._free.remove(b)
                self._refs[b] = 1
                self.cached_free_revivals += 1
                self._c_revive.inc()
            self._last_hit[b] = self.step_now
        # pin every compressed hit's slot FIRST: the _pop_free calls
        # below can demote dying cached-free entries into a full int8
        # pool, which would otherwise spill the very slots this table is
        # about to read or promote from
        mid_blocks: List[int] = []      # compressed hits, in table order
        n_promoted = 0
        if chits:
            self._promote_slots.update(s for _, s, p in chits if p)
            for _, s, p in chits:
                if not p:
                    self._cslot_refs[s] = self._cslot_refs.get(s, 0) + 1
            for key, slot, p in chits:
                self._chits[key] = self._chits.get(key, 0) + 1
                self._cindex.move_to_end(key)        # LRU touch: hottest
                if not p:
                    mid_blocks.append(-(slot + 1))
                    self.direct_reads += 1
                    self._c_direct_reads.inc()
                    continue
                b = self._pop_free()
                self._refs[b] = 1
                mid_blocks.append(b)
                n_promoted += 1
                self._pending_promotes.append((b, slot))
                self._last_hit[b] = self.step_now
                if key not in self._index and b not in self._key_of:
                    self._index[key] = b
                    self._key_of[b] = key
                self.promoted_total += 1
                self._c_promote.inc()
        # host-tier hits claim fresh blocks and stage their loads; the
        # key registers first-wins so later prompts can share the block
        # as soon as the engine writes the load
        host_blocks: List[int] = []
        for key, layers in host_loads:
            b = self._pop_free()
            self._refs[b] = 1
            host_blocks.append(b)
            self._pending_host_loads.append((b, layers))
            self._last_hit[b] = self.step_now
            if key not in self._index and b not in self._key_of:
                self._index[key] = b
                self._key_of[b] = key
        fresh = [self._pop_free()
                 for _ in range(need - n_promoted - len(host_blocks))]
        for b in fresh:
            self._refs[b] = 1
            self._last_hit[b] = self.step_now
        self._tables[seq_id] = matched + mid_blocks + host_blocks + fresh
        self._lens[seq_id] = n
        self._tokens[seq_id] = list(tokens)
        cached = min((len(matched) + len(chits) + len(host_blocks))
                     * bs, n - 1)
        self._committed[seq_id] = cached
        if chits:
            self.compress_hit_tokens += max(
                0, min((len(matched) + len(chits)) * bs, cached)
                - len(matched) * bs)
        if n_direct:
            self.direct_read_tokens += n_direct * bs
            self._c_direct_toks.inc(n_direct * bs)
        if host_blocks:
            tier_toks = max(0, cached - (len(matched) + len(chits)) * bs)
            self.tier_revivals += len(host_blocks)
            self.tier_hit_tokens += tier_toks
            self.host_tier.note_revived(len(host_blocks), tier_toks)
        if count_stats:
            self.hit_tokens += cached
            self.prompt_tokens += n
            self._c_hit_toks.inc(cached)
            self._c_prompt_toks.inc(n)
        return cached

    def ensure_writable(self, seq_id: int, start: int, end: int) -> None:
        """Copy-on-write pass before the engine scatters positions
        [start, end): every touched block with refcount > 1 is swapped
        for a fresh private block and an on-device (src, dst) block
        copy is queued (drain_copies) so already-valid positions in the
        block survive. Raises CacheExhausted when a COW needs a block
        and the free list is empty."""
        table = self._tables[seq_id]
        bs = self.block_size
        for bi in range(start // bs, (max(end, start + 1) - 1) // bs + 1):
            old = table[bi]
            if old < 0:
                # unreachable by construction: writes land at positions
                # >= cached, and alloc_sequence promotes the one
                # compressed hit a capped full-prompt write can touch.
                # Fail loudly rather than corrupt a shared int8 slot.
                raise RuntimeError(
                    f"copy-on-write reached int8-resident entry {old} "
                    f"(seq {seq_id}, block index {bi})")
            if self._refs[old] <= 1:
                continue
            if not self._free:
                raise CacheExhausted("no free block for copy-on-write")
            new = self._pop_free()
            self._refs[old] -= 1
            self._refs[new] = 1
            table[bi] = new
            self._pending_copies.append((old, new))
            self.cow_copies += 1
            self._c_cow.inc()

    def drain_copies(self) -> List[Tuple[int, int]]:
        """Queued COW block copies; the engine MUST replay them on the
        device pools (src block -> dst block, every layer) before the
        next step reads or writes the dst blocks."""
        out, self._pending_copies = self._pending_copies, []
        return out

    def drain_host_loads(self) -> List[Tuple[int, list]]:
        """Staged host-tier revivals: (block, per-layer [(k, v)] host
        arrays). The engine MUST write them into the pools BEFORE
        draining COW copies — a just-revived block can be the src of a
        same-plan copy-on-write."""
        out, self._pending_host_loads = self._pending_host_loads, []
        return out

    def drain_compress(self) -> List[Tuple[int, int]]:
        """Staged (fp block, int8 slot) quantizations. The engine MUST
        flush these FIRST — before promotions, host loads and COW
        copies — so the
        quantize lanes read every src block ahead of any same-plan
        writer reusing it."""
        out, self._pending_compress = self._pending_compress, []
        return out

    def drain_promotes(self) -> List[Tuple[int, int]]:
        """Staged (fp block, int8 slot) dequantize promotions, flushed
        AFTER compressions (a promote may read a slot the same plan just
        filled) and BEFORE host loads, COW copies and the step."""
        out, self._pending_promotes = self._pending_promotes, []
        self._promote_slots = set()
        return out

    def commit_prefill(self, seq_id: int, upto: int) -> None:
        """Mark positions [0, upto) as present in the pool (a prefill
        chunk just scattered them) and register every newly-full block
        in the prefix index so later prompts can share it."""
        self._committed[seq_id] = max(self._committed.get(seq_id, 0), upto)
        self._register_full_blocks(seq_id)

    def committed_len(self, seq_id: int) -> int:
        return self._committed.get(seq_id, 0)

    def _register_full_blocks(self, seq_id: int) -> None:
        if not self.enable_prefix_cache:
            return
        bs = self.block_size
        table = self._tables[seq_id]
        toks = self._tokens[seq_id]
        for bi in range(self._committed[seq_id] // bs):
            block = table[bi]
            if block < 0:
                continue    # int8-resident: indexed by _cindex, not here
            if block in self._key_of:
                continue                    # already indexed (maybe shared)
            key = tuple(toks[:(bi + 1) * bs])
            if key in self._index:
                continue                    # duplicate content: first wins
            self._index[key] = block
            self._key_of[block] = key

    def append_token(self, seq_id: int) -> int:
        """Reserve the slot for this sequence's next token (allocating a
        fresh block at a block boundary, COWing a shared tail block);
        returns the FLAT pool slot (block_id * block_size + offset).
        Does NOT advance the length — call advance() after the step
        actually writes."""
        return self.reserve_slots(seq_id, 1)[0]

    def reserve_slots(self, seq_id: int, count: int) -> List[int]:
        """Reserve the next `count` token slots in one ALL-OR-NOTHING
        transaction (a speculative decode window: the base token plus k
        drafts). The bill — COW copies for shared blocks the window
        touches plus fresh blocks past the table's end — is checked
        first, and CacheExhausted raises BEFORE any refcount or table
        changes, so a failed reservation leaves nothing to roll back.
        Returns the flat pool slots in window order. The length does not
        advance: the engine calls advance() only for the positions
        verification accepted, and the slots past them are reserved
        (and overwritten) again by the next step — that IS the
        speculative rollback."""
        pos = self._lens[seq_id]
        table = self._tables[seq_id]
        bs = self.block_size
        end = pos + count
        in_table_end = min(end, len(table) * bs)
        cow_need = 0
        if in_table_end > pos:
            cow_need = sum(
                1 for bi in range(pos // bs, (in_table_end - 1) // bs + 1)
                if self._refs[table[bi]] > 1)
        new_need = max(0, self.blocks_for(end) - len(table))
        if cow_need + new_need > len(self._free):
            raise CacheExhausted(
                f"need {cow_need + new_need} blocks ({cow_need} COW + "
                f"{new_need} fresh), {len(self._free)} free")
        if in_table_end > pos:
            self.ensure_writable(seq_id, pos, in_table_end)
        for _ in range(new_need):
            block = self._pop_free()
            self._refs[block] = 1
            self._last_hit[block] = self.step_now
            table.append(block)
        return [table[(pos + j) // bs] * bs + (pos + j) % bs
                for j in range(count)]

    def fork_sequence(self, src_id: int, dst_id: int) -> None:
        """Clone `src_id`'s sequence state into `dst_id` sharing EVERY
        block (refcount bump — no new block, no device copy): the
        parallel-sampling primitive. The first time a fork writes (its
        own tokens, starting with the shared partly filled tail block),
        ensure_writable's copy-on-write gives it a private copy. A
        shared int8 direct-read slot (a negative table entry) gets its
        pin bumped instead, so free_sequence drops both the same way."""
        if dst_id in self._tables:
            raise ValueError(f"sequence {dst_id} already allocated")
        table = self._tables[src_id]
        for b in table:
            if b < 0:
                self._cslot_refs[-b - 1] += 1
            else:
                self._refs[b] += 1
        self._tables[dst_id] = list(table)
        self._lens[dst_id] = self._lens[src_id]
        self._tokens[dst_id] = list(self._tokens[src_id])
        self._committed[dst_id] = self._committed[src_id]

    def advance(self, seq_id: int, token: int) -> None:
        """The decode step wrote `token`'s k/v at the reserved slot:
        extend the sequence and index the tail block if it just
        filled (generated continuations are shareable too)."""
        self._tokens[seq_id].append(token)
        self._lens[seq_id] += 1
        self._committed[seq_id] = self._lens[seq_id]
        if self._lens[seq_id] % self.block_size == 0:
            self._register_full_blocks(seq_id)

    def free_sequence(self, seq_id: int) -> int:
        """Drop this sequence's references; blocks whose refcount hits
        zero return to the free list but KEEP their prefix-index entry
        (cached-free). Queued COW copies targeting a freed block are
        cancelled — the pool may hand the block straight back out, and
        a stale copy flushing later would clobber the new owner's KV.
        Returns how many blocks went back to the free list."""
        blocks = self._tables.pop(seq_id, [])
        self._lens.pop(seq_id, None)
        self._tokens.pop(seq_id, None)
        self._committed.pop(seq_id, None)
        freed_set = set()
        for b in blocks:
            if b < 0:
                # direct-read entry: unpin the int8 slot; its payload
                # stays resident in _cindex and becomes spillable again
                # once its last reader drops
                slot = -b - 1
                left = self._cslot_refs.get(slot, 0) - 1
                if left > 0:
                    self._cslot_refs[slot] = left
                else:
                    self._cslot_refs.pop(slot, None)
                continue
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
                # in live use until this step: its coldness clock starts
                self._last_hit[b] = self.step_now
                freed_set.add(b)
        if freed_set and self._pending_copies:
            self._pending_copies = [
                (s, d) for s, d in self._pending_copies
                if d not in freed_set]
        if freed_set and self._pending_host_loads:
            # cancel-mid-revival: the request died before its staged
            # host loads were written. The freed blocks were indexed for
            # content that never arrived — deregister them (the tier
            # still holds the data; a re-request revives it anew)
            stale = [b for b, _ in self._pending_host_loads
                     if b in freed_set]
            if stale:
                self._pending_host_loads = [
                    (b, la) for b, la in self._pending_host_loads
                    if b not in freed_set]
                for b in stale:
                    key = self._key_of.pop(b, None)
                    if key is not None and self._index.get(key) == b:
                        del self._index[key]
        if freed_set and self._pending_promotes:
            # cancel-mid-promotion: a freed dst block may be handed out
            # again at once, and a stale dequantize flushing later would
            # clobber the new owner's KV. The compressed entry still
            # holds the payload; a re-request promotes it anew.
            stale = [b for b, _ in self._pending_promotes if b in freed_set]
            if stale:
                self._pending_promotes = [
                    (b, s) for b, s in self._pending_promotes
                    if b not in freed_set]
                self._promote_slots = {s for _, s in self._pending_promotes}
                for b in stale:
                    key = self._key_of.pop(b, None)
                    if key is not None and self._index.get(key) == b:
                        del self._index[key]
        return len(freed_set)

    # -- views for the step ----------------------------------------------
    def seq_len(self, seq_id: int) -> int:
        return self._lens[seq_id]

    def block_table(self, seq_id: int) -> List[int]:
        return list(self._tables[seq_id])

    def slot_of(self, seq_id: int, pos: int) -> int:
        """Flat pool slot of an ALREADY-RESERVED position."""
        table = self._tables[seq_id]
        return table[pos // self.block_size] * self.block_size \
            + pos % self.block_size

    def padded_table(self, seq_id: int, max_blocks: int) -> List[int]:
        """Block table right-padded with scratch block 0 to the fixed
        width of the step's operands (int8-resident entries stay
        bias-encoded)."""
        table = self._tables[seq_id]
        if len(table) > max_blocks:
            raise ValueError(f"sequence {seq_id} spans {len(table)} blocks "
                             f"> max {max_blocks}")
        return table + [0] * (max_blocks - len(table))

    def prefix_keys(self, limit: int = 512) -> List[tuple]:
        """Most recently indexed prefix keys (device tier): the engine's
        half of the fleet prefix directory advertisement. Engine-loop
        thread only (reads the unlocked index)."""
        keys = list(self._index.keys())
        return keys[-limit:] if limit and len(keys) > limit else keys

    def compressed_keys(self, limit: int = 512) -> List[tuple]:
        """Most recently touched compressed-tier keys (hottest last)."""
        keys = list(self._cindex.keys())
        return keys[-limit:] if limit and len(keys) > limit else keys

    @property
    def compress_enabled(self) -> bool:
        """Whether the in-device int8 tier is active (budget > 0 and
        prefix caching on)."""
        return self._compress_on

    @property
    def direct_read_enabled(self) -> bool:
        """Whether compressed hits are read in place by the mixed step
        (promote_hits != 1; 1 restores always-promote)."""
        return self._compress_on and self.promote_hits != 1

    @property
    def compressed_resident(self) -> int:
        return len(self._cindex)

    @property
    def compress_free_slots(self) -> int:
        """Unused int8 slots: the scheduler's victim costing caps the
        cheap-rung credit by this."""
        return len(self._cfree)

    def effective_pool_bytes(self) -> int:
        """fp-equivalent bytes of UNIQUE KV the device holds: the fp pool
        plus compressed entries whose content lives ONLY in the int8
        tier (a proactively compressed block keeps its fp copy, and is
        counted once)."""
        blk = (2 * self.block_size * self.num_kv_heads * self.head_dim
               * self.dtype.itemsize * len(self.pools))
        uniq = sum(1 for k in self._cindex if k not in self._index)
        return (self.num_blocks - 1 + uniq) * blk

    # -- observability ----------------------------------------------------
    def hit_rate(self) -> float:
        """Fraction of all prompt tokens served from the prefix cache."""
        return self.hit_tokens / max(1, self.prompt_tokens)

    def stats(self) -> Dict[str, float]:
        out = {
            "hit_tokens": self.hit_tokens,
            "prompt_tokens": self.prompt_tokens,
            "hit_rate": round(self.hit_rate(), 4),
            "cow_copies": self.cow_copies,
            "cached_free_evictions": self.cached_free_evictions,
            "cached_free_revivals": self.cached_free_revivals,
            "shared_blocks": self.shared_blocks,
            "used_blocks": self.used_blocks,
            "occupancy": round(self.occupancy(), 4),
        }
        if self._compress_on:
            out["compressed_blocks"] = len(self._cindex)
            out["compress_total"] = self.compressed_total
            out["promote_total"] = self.promoted_total
            out["compress_spills"] = self.compress_spills
            out["compress_hit_tokens"] = self.compress_hit_tokens
            out["direct_int8_reads"] = self.direct_reads
            out["direct_int8_tokens"] = self.direct_read_tokens
        if self.host_tier is not None:
            out["tier_revivals"] = self.tier_revivals
            out["tier_hit_tokens"] = self.tier_hit_tokens
            out.update(self.host_tier.stats())
        return out

    def reset_stats(self) -> None:
        self.hit_tokens = self.prompt_tokens = self.cow_copies = 0
        self.cached_free_evictions = self.cached_free_revivals = 0
        self.tier_revivals = self.tier_hit_tokens = 0
        self.compressed_total = self.promoted_total = 0
        self.compress_spills = self.compress_hit_tokens = 0
        self.direct_reads = self.direct_read_tokens = 0

    def assert_quiesced(self) -> None:
        """Leak check: with no live sequences every refcount must be
        gone and the free list full. Index entries may remain, but only
        for cached-free blocks; an indexed block NOT on the free list
        is a leak."""
        if self._tables:
            raise RuntimeError(f"live sequences: {list(self._tables)}")
        if self._refs:
            raise RuntimeError(f"leaked refcounts: {self._refs}")
        if self._pending_host_loads:
            raise RuntimeError(
                f"{len(self._pending_host_loads)} host-tier loads never "
                "flushed")
        if self._pending_compress:
            raise RuntimeError(
                f"{len(self._pending_compress)} compress lanes never "
                "flushed")
        if self._pending_promotes:
            raise RuntimeError(
                f"{len(self._pending_promotes)} promote lanes never "
                "flushed")
        if self._cslot_refs:
            raise RuntimeError(
                f"leaked direct-read slot pins: {self._cslot_refs}")
        if self._compress_on and \
                len(self._cfree) + len(self._cindex) != self.compress_blocks:
            raise RuntimeError(
                f"compressed-slot leak: {len(self._cfree)} free + "
                f"{len(self._cindex)} resident != {self.compress_blocks}")
        if len(self._free) != self.num_blocks - 1:
            raise RuntimeError(
                f"free list {len(self._free)} != {self.num_blocks - 1}")
        free = set(self._free)
        leaked = [b for b in self._key_of if b not in free]
        if leaked:
            raise RuntimeError(
                f"indexed blocks not on the free list: {leaked}")
