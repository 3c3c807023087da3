"""PagedKVCache: refcounted block-pool KV storage with prefix sharing
(port of paddle_tpu/engine/paged_cache.py; the host-tier, in-device
int8 compression and tensor-parallel branches are not ported yet).

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

Host/device split: this class is the HOST-side allocator + bookkeeping.
The device-side pools are torch tensors in `self.pools`, allocated
with zeros (never torch.empty: masked attention lanes multiply p = 0
by V, and 0 * NaN from uninitialised memory would poison real rows)
and written IN PLACE by the engine's step and COW copies.

Block 0 is reserved as a scratch block: padded batch rows write their
garbage k/v there, so a dummy row can never corrupt a live sequence.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.obs.metrics import MetricsRegistry, default_registry


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
                 registry: Optional[MetricsRegistry] = None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.device = resolve_device(device)
        self.enable_prefix_cache = enable_prefix_cache
        shape = (num_blocks, block_size, num_kv_heads, head_dim)
        self.pools: List[Tuple[torch.Tensor, torch.Tensor]] = [
            (torch.zeros(shape, dtype=dtype, device=self.device),
             torch.zeros(shape, dtype=dtype, device=self.device))
            for _ in range(num_layers)]
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

    # -- capacity ---------------------------------------------------------
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
        content is evicted first)."""
        block = self._free.popleft()
        key = self._key_of.pop(block, None)
        if key is not None and self._index.get(key) == block:
            del self._index[key]
            self.cached_free_evictions += 1
            self._c_evict.inc()
        return block

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
        prefix blocks from the index. Returns the number of CACHED
        tokens (KV already in the pool — the engine prefills only the
        suffix). A full-prompt hit is capped at n-1 so the last token
        always recomputes (its logits seed sampling); that write lands
        inside a shared block and COWs it. Raises CacheExhausted
        (allocating nothing) when the free list is short.
        `count_stats=False` leaves hit_tokens/prompt_tokens untouched:
        a preemption re-admission re-hits its own just-committed blocks
        and would otherwise inflate hit_rate."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        n = len(tokens)
        matched = self._match_prefix(tokens)
        need = self.blocks_for(n) - len(matched)
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
        fresh = [self._pop_free() for _ in range(need)]
        for b in fresh:
            self._refs[b] = 1
        self._tables[seq_id] = matched + fresh
        self._lens[seq_id] = n
        self._tokens[seq_id] = list(tokens)
        cached = min(len(matched) * self.block_size, n - 1)
        self._committed[seq_id] = cached
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
        pos = self._lens[seq_id]
        table = self._tables[seq_id]
        bs = self.block_size
        in_table = pos < len(table) * bs
        cow_need = int(in_table and self._refs[table[pos // bs]] > 1)
        new_need = max(0, self.blocks_for(pos + 1) - len(table))
        if cow_need + new_need > len(self._free):
            raise CacheExhausted(
                f"need {cow_need + new_need} blocks ({cow_need} COW + "
                f"{new_need} fresh), {len(self._free)} free")
        if in_table:
            self.ensure_writable(seq_id, pos, pos + 1)
        for _ in range(new_need):
            block = self._pop_free()
            self._refs[block] = 1
            table.append(block)
        return table[pos // bs] * bs + pos % bs

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
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
                freed_set.add(b)
        if freed_set and self._pending_copies:
            self._pending_copies = [
                (s, d) for s, d in self._pending_copies
                if d not in freed_set]
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
        width of the step's operands."""
        table = self._tables[seq_id]
        if len(table) > max_blocks:
            raise ValueError(f"sequence {seq_id} spans {len(table)} blocks "
                             f"> max {max_blocks}")
        return table + [0] * (max_blocks - len(table))

    # -- observability ----------------------------------------------------
    def hit_rate(self) -> float:
        """Fraction of all prompt tokens served from the prefix cache."""
        return self.hit_tokens / max(1, self.prompt_tokens)

    def stats(self) -> Dict[str, float]:
        return {
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

    def reset_stats(self) -> None:
        self.hit_tokens = self.prompt_tokens = self.cow_copies = 0
        self.cached_free_evictions = self.cached_free_revivals = 0

    def assert_quiesced(self) -> None:
        """Leak check: with no live sequences every refcount must be
        gone and the free list full. Index entries may remain, but only
        for cached-free blocks; an indexed block NOT on the free list
        is a leak."""
        if self._tables:
            raise RuntimeError(f"live sequences: {list(self._tables)}")
        if self._refs:
            raise RuntimeError(f"leaked refcounts: {self._refs}")
        if len(self._free) != self.num_blocks - 1:
            raise RuntimeError(
                f"free list {len(self._free)} != {self.num_blocks - 1}")
        free = set(self._free)
        leaked = [b for b in self._key_of if b not in free]
        if leaked:
            raise RuntimeError(
                f"indexed blocks not on the free list: {leaked}")
