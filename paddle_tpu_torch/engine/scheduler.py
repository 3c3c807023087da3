"""Continuous batching scheduler with chunked prefill (port of
paddle_tpu/engine/scheduler.py, pure Python).

Continuous batching reschedules every STEP: finished sequences leave
the running set immediately, waiting requests are admitted the moment
blocks free up, and each step the scheduler hands the engine ONE MIXED
plan — every decode-ready row plus budget-bounded prefill chunks,
packed into the same launch.

- Admission is FIFO and block-bound only: a request admits when a
  batch slot is open and its prompt's blocks fit (prefix-cache hits
  shrink the bill). Admission allocates the WHOLE prompt's blocks and
  records how many leading tokens the prefix cache already holds —
  those are never prefilled.
- MIXED STEPS: every step carries one row per running request — a
  decode row (its next token) for decode-ready sequences, a prefill
  chunk of at most `max_prefill_tokens` total tokens for sequences
  still prefilling. A decode row is the 1-token window
  [seq_len, seq_len+1) of req.tokens; with a drafter (speculative
  decoding, engine/draft.py) it widens to [seq_len, seq_len+1+k), the
  base token plus k drafted tokens, when the pool holds the whole
  window — a short pool drops the draft, never preempts for it.
- Parallel sampling: a request with n_candidates > 1 claims a batch
  slot for each candidate from admission on, so the siblings the
  engine forks at its final chunk always have room to decode.
- Preemption by recompute: when a decode append or a COW copy needs a
  block and the pool is empty, the running request with the most
  deadline slack is evicted — last admitted on ties, or with a lower
  tier attached (the int8 tier, the host tier) the one whose round
  trip costs least — its blocks are demoted and dropped, and it
  rejoins the FRONT of the waiting queue with prompt := prompt +
  generated, so its re-prefill reproduces the exact KV state.

The scheduler owns no device state; it manipulates the PagedKVCache's
host-side bookkeeping and Request objects.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from paddle_tpu_torch.engine.paged_cache import CacheExhausted, PagedKVCache

# request lifecycle: WAITING -> RUNNING -> FINISHED (PREEMPTED -> WAITING)
WAITING, RUNNING, FINISHED = "waiting", "running", "finished"

_req_ids = itertools.count()


@dataclass
class Request:
    """One inference request; `prompt` grows on preemption (recompute)."""
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => full vocab
    seed: int = 0
    eos_id: Optional[int] = None
    callback: Optional[Callable[[int], None]] = None  # per-token stream
    # absolute monotonic completion deadline (inf = none). The
    # scheduler's preemption choice reads it: the victim is the running
    # request with the MOST slack.
    deadline: float = float("inf")
    # parallel sampling (best-of-n): the engine forks n_candidates - 1
    # siblings off this request's finished prefill, all sharing its
    # prompt blocks (PagedKVCache.fork_sequence). Siblings are ordinary
    # requests with cand_index > 0 and `parent` set; the primary lists
    # them in `forks`. fork_callback(i) builds sibling i's per-token
    # stream callback (None = decode silently).
    n_candidates: int = 1
    cand_index: int = 0
    parent: Optional["Request"] = None
    forks: List["Request"] = field(default_factory=list)
    fork_callback: Optional[Callable[[int],
                                     Optional[Callable[[int], None]]]] = None
    # cumulative log-probability of the sampled tokens under each
    # step's sampling distribution
    logprob_sum: float = 0.0
    req_id: int = field(default_factory=lambda: next(_req_ids))
    generated: List[int] = field(default_factory=list)
    state: str = WAITING
    preemptions: int = 0
    preempt_carry: int = 0            # tokens folded into prompt on preempt
    prefill_pos: int = 0              # prompt tokens prefilled (or cached)
    cached_tokens: int = 0            # prefix-cache hit at last admission
    enqueue_time: float = 0.0
    admit_time: float = 0.0           # first admission (queue-wait metric)
    first_token_time: float = 0.0
    finish_time: float = 0.0
    finish_reason: str = ""

    @property
    def tokens(self) -> List[int]:
        """Prompt as the cache must hold it (original + regenerated)."""
        return self.prompt + self.generated

    @property
    def num_generated(self) -> int:
        """Tokens generated across preemptions (prompt absorbs them)."""
        return len(self.generated) + self.preempt_carry

    @property
    def prefilling(self) -> bool:
        # against the PROMPT, not tokens: generated tokens enter the
        # cache via decode's append/advance, never via a chunk
        return self.prefill_pos < len(self.prompt)


@dataclass
class StepRow:
    """One row of a mixed step: run `req`'s token window
    [start, start + length). decode=True is the next-token window of a
    decode-ready sequence (its slots already reserved); decode=False is
    a prefill chunk of the prompt. A decode row with a non-empty
    `draft` is a SPECULATIVE row: its window is [start, start+1+k) —
    the base token plus k drafted tokens — and the engine verifies all
    k positions from the one step, emitting the accepted prefix."""
    req: Request
    start: int
    length: int
    decode: bool = False
    draft: List[int] = field(default_factory=list)


# JAX's back-compat alias (scheduler.py:136): a prefill chunk is a
# StepRow with decode=False
PrefillChunk = StepRow

Plan = List[StepRow]


class Scheduler:
    """Decides, per engine step, what work runs: one mixed plan of
    decode rows and prefill chunks. Bounds: `max_batch_size` concurrent
    running sequences, `max_prefill_tokens` prompt tokens per step's
    chunks (decode rows ride free), `max_seq_len` ceiling on
    prompt+generation."""

    def __init__(self, cache: PagedKVCache, max_batch_size: int = 8,
                 max_prefill_tokens: int = 512, max_seq_len: int = 2048,
                 drafter=None):
        self.cache = cache
        self.max_batch_size = max_batch_size
        self.max_prefill_tokens = max_prefill_tokens
        self.max_seq_len = max_seq_len
        # speculative decoding: when set, decode-ready rows carry up to
        # drafter.k drafted tokens for batched verification
        self.drafter = drafter
        self.waiting: deque[Request] = deque()
        self.running: List[Request] = []
        # engine hooks: fired after a preemption moves a req back to
        # waiting / after admission moves one to running
        self.on_preempt: Optional[Callable[[Request], None]] = None
        self.on_admit: Optional[Callable[[Request], None]] = None

    # -- intake -----------------------------------------------------------
    def add(self, req: Request) -> None:
        if len(req.prompt) > self.max_seq_len:
            raise ValueError(
                f"prompt len {len(req.prompt)} > max_seq_len {self.max_seq_len}")
        req.state = WAITING
        self.waiting.append(req)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- planning ---------------------------------------------------------
    def next_batch(self) -> Optional[Plan]:
        """Plan one MIXED step: a list of StepRows (decode rows plus
        prefill chunks, one row per running request, in admission
        order) or None when idle. Admission allocates cache blocks
        (prefix hits included) and moves requests to RUNNING; chunk
        planning advances `prefill_pos` optimistically (the engine
        always executes the plan it is handed); every decode row has
        its next-token block reserved before it enters the plan,
        preempting if the pool runs dry. The chunk token budget goes to
        the head request first."""
        self._try_admit()
        if not self.running:
            self._check_liveness()
            return None
        rows: List[StepRow] = []
        budget = self.max_prefill_tokens
        for req in list(self.running):
            if req not in self.running:     # preempted by an earlier row
                continue
            if req.prefilling:
                if budget <= 0:
                    continue
                take = min(len(req.prompt) - req.prefill_pos, budget)
                start = req.prefill_pos
                # COW (a chunk writing into a shared block) may need a
                # free block; a dry pool preempts
                self._ensure_writable_or_preempt(req, start, start + take)
                req.prefill_pos += take
                budget -= take
                rows.append(StepRow(req, start, take, decode=False))
            else:
                draft = self._propose_draft(req)
                if draft:
                    try:
                        # all-or-nothing: base token + k draft slots in
                        # one transaction; a short pool drops the draft
                        # rather than preempting for it
                        self.cache.reserve_slots(req.req_id,
                                                 1 + len(draft))
                        rows.append(StepRow(
                            req, self.cache.seq_len(req.req_id),
                            1 + len(draft), decode=True, draft=draft))
                        continue
                    except CacheExhausted:
                        pass
                if self._reserve_decode_block(req):
                    rows.append(StepRow(
                        req, self.cache.seq_len(req.req_id), 1,
                        decode=True))
        # a later row's block starvation may have evicted an
        # ALREADY-planned request: its table is freed and prefill_pos
        # reset, so its row must not reach the engine
        rows = [w for w in rows if w.req in self.running]
        if rows:
            return rows
        if self.running:
            return self.next_batch()    # everything preempted; replan
        self._check_liveness()
        return None

    def _propose_draft(self, req: Request) -> List[int]:
        """Draft tokens for one decode-ready row, capped so the whole
        speculative window — base token + k drafts, each of which may
        EMIT a token — never overruns the request's token budget or the
        sequence-length ceiling."""
        if self.drafter is None:
            return []
        room = min(self.drafter.k,
                   req.max_new_tokens - req.num_generated - 1,
                   self.max_seq_len - len(req.tokens) - 1)
        if room <= 0:
            return []
        return self.drafter.propose(req.tokens, room)

    def _slots_of(self, req: Request) -> int:
        """Batch slots a request claims: itself, plus — while it still
        prefills — one per sibling the engine will fork at its final
        chunk, so the forks' decode rows have batch room the moment
        they exist."""
        if not req.prefilling:
            return 1
        return 1 + max(0, req.n_candidates - 1 - len(req.forks))

    def _try_admit(self) -> List[Request]:
        admitted: List[Request] = []
        while self.waiting:
            req = self.waiting[0]
            slots = (sum(self._slots_of(r) for r in self.running)
                     + sum(self._slots_of(r) for r in admitted))
            if (slots + self._slots_of(req) > self.max_batch_size
                    or not self.cache.can_allocate(req.tokens)):
                break       # FIFO: don't skip ahead of the head request
            self.waiting.popleft()
            # re-admissions re-hit their own committed blocks; don't let
            # that inflate the prefix-cache hit rate
            cached = self.cache.alloc_sequence(
                req.req_id, req.tokens, count_stats=req.preemptions == 0)
            req.prefill_pos = cached
            req.cached_tokens = cached
            req.state = RUNNING
            admitted.append(req)
        self.running.extend(admitted)
        if self.on_admit is not None:
            for req in admitted:
                self.on_admit(req)
        return admitted

    def _ensure_writable_or_preempt(self, req: Request, start: int,
                                    end: int) -> None:
        """COW the chunk's target blocks, evicting other requests
        (never `req` itself) while the pool is dry."""
        while True:
            try:
                self.cache.ensure_writable(req.req_id, start, end)
                return
            except CacheExhausted:
                victim = self._pick_victim(req)
                if victim is None:
                    raise
                self.preempt(victim)

    def _reserve_decode_block(self, req: Request) -> bool:
        """Ensure a decode-ready sequence can hold one more token,
        evicting until allocation holds. Returns False when `req`
        itself was preempted along the way."""
        while req in self.running:
            try:
                self.cache.append_token(req.req_id)
                return True
            except CacheExhausted:
                victim = self._pick_victim(req)
                if victim is None:
                    raise CacheExhausted(
                        "single sequence exceeds total KV pool; "
                        "increase num_blocks or lower max_seq_len")
                self.preempt(victim)
        return False

    def _preempt_cost(self, req: Request) -> float:
        """Modeled cost of evicting `req` and bringing it back. Without
        a lower tier every committed token re-prefills, and attention
        over the growing context makes that ~n^2. With a host tier,
        committed FULL blocks swap out and revive by copy (linear in
        bytes, ~n) and only the uncommitted tail re-prefills (~tail^2).
        The in-device int8 rung is cheaper still — demotion and revival
        are on-device reads (direct, rate 0.1) or promote scatters (rate
        0.25) — but only for as many blocks as the int8 pool has FREE
        slots; a demotion beyond that spills to the host rung (with a
        tier) or drops the content (without one, so it re-prefills)."""
        n = len(req.tokens)
        if self.cache.host_tier is None \
                and not self.cache.compress_enabled:
            return float(n * n)
        bs = self.cache.block_size
        full = (n // bs) * bs
        tail = n - full
        if self.cache.compress_enabled:
            cheap = min(full, self.cache.compress_free_slots * bs)
            rest = full - cheap
            rate = 0.1 if self.cache.direct_read_enabled else 0.25
            if self.cache.host_tier is not None:
                return float(cheap * rate + rest + tail * tail)
            return float(cheap * rate + rest * rest + tail * tail)
        return float(full + tail * tail)

    def _pick_victim(self, keep: Optional[Request]) -> Optional[Request]:
        """The running request (other than `keep`) with the MOST
        deadline slack; without deadlines every slack is +inf and the
        choice degrades to the last admitted. With a host tier or the
        int8 tier attached, equal-slack candidates are split by the
        swap-vs-recompute cost model (_preempt_cost: the cheapest round
        trip loses its blocks). None when nothing else is left to
        evict."""
        best: Optional[Request] = None
        if self.cache.host_tier is None \
                and not self.cache.compress_enabled:
            for r in self.running:      # later index wins ties (stable max)
                if r is not keep and (best is None
                                      or r.deadline >= best.deadline):
                    best = r
            return best
        best_cost = 0.0
        for r in self.running:          # later index wins ties (stable max)
            if r is keep:
                continue
            cost = self._preempt_cost(r)
            if (best is None or r.deadline > best.deadline
                    or (r.deadline == best.deadline and cost <= best_cost)):
                best, best_cost = r, cost
        return best

    def preempt(self, req: Request) -> None:
        """Evict by recompute: drop block refs, fold generated tokens
        into the prompt, and requeue at the FRONT so it re-prefills
        first. With a lower tier attached, the committed blocks demote
        into it first, so re-admission reads or revives them instead of
        recomputing them."""
        self.cache.demote_sequence(req.req_id)
        self.cache.free_sequence(req.req_id)
        self.running.remove(req)
        req.preempt_carry += len(req.generated)
        req.prompt = req.prompt + req.generated
        req.generated = []
        req.preemptions += 1
        req.prefill_pos = 0
        req.state = WAITING
        self.waiting.appendleft(req)
        if self.on_preempt is not None:
            self.on_preempt(req)

    def _check_liveness(self) -> None:
        """With an idle engine and an empty pool, a head request that
        still can't admit NEVER will — fail loud instead of silently
        stranding it in the queue."""
        if not self.waiting or self.running:
            return
        req = self.waiting[0]
        n = len(req.tokens)
        if self.cache.blocks_for(n) > self.cache.num_blocks - 1:
            raise CacheExhausted(
                f"request {req.req_id} ({n} tokens incl. "
                f"{req.preempt_carry} preempt-folded) can never be "
                f"scheduled; raise num_blocks ({self.cache.num_blocks})")

    # -- completion -------------------------------------------------------
    def finish(self, req: Request, reason: str) -> None:
        self.cache.free_sequence(req.req_id)
        self.running.remove(req)
        req.state = FINISHED
        req.finish_reason = reason

    def cancel(self, req: Request) -> bool:
        """Remove a request wherever it sits — the wait queue (no KV
        held) or the running set (frees its blocks; shared prefix blocks
        just drop one reference). Returns False when the request already
        finished. Engine-thread only, BETWEEN steps."""
        if req in self.running:
            self.cache.free_sequence(req.req_id)
            self.running.remove(req)
        elif req in self.waiting:
            self.waiting.remove(req)
        else:
            return False
        req.state = FINISHED
        req.finish_reason = "cancelled"
        return True
