"""The port's prefix-shared KV cache and chunked prefill, mirroring
tests/test_prefix_cache.py on paddle_tpu_torch (device="cpu").

The guarantees under test are the JAX engine's: sharing is invisible
(a request riding refcounted shared blocks produces exactly the tokens
it produces with sharing off; copy-on-write isolates divergence),
chunking is invisible (budget-bounded chunks interleaved with decode
give the monolithic result), and nothing leaks (`assert_quiesced`).
Where a scenario has a JAX twin, the JAX engine's streams are the
oracle too.
"""

import json

import jax
import jax.numpy as jnp
import pytest

from paddle_tpu.engine import ServeEngine as JaxServeEngine
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.engine import (PagedKVCache, Request, Scheduler,
                                     ServeEngine)
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.testing import causal_lm_tree

VOCAB = 61
DIMS = dict(model_dim=16, num_heads=4, num_layers=2, ffn_dim=32)


@pytest.fixture(scope="module")
def models():
    tree = causal_lm_tree(1, VOCAB, **DIMS)
    tm = CausalLM(VOCAB, dropout=0.0, max_len=64, device="cpu", **DIMS)
    load_jax_params(tm, tree)
    jm = JaxCausalLM(VOCAB, dropout=0.0, max_len=64, **DIMS)
    return tm, jm, jax.tree_util.tree_map(jnp.asarray, tree)


def _engine(tm, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    return ServeEngine(tm, device="cpu", registry=MetricsRegistry(), **kw)


def _cache(**kw):
    kw.setdefault("num_layers", 1)
    kw.setdefault("num_blocks", 16)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_kv_heads", 2)
    kw.setdefault("head_dim", 8)
    return PagedKVCache(device="cpu", registry=MetricsRegistry(), **kw)


# -- allocator-level sharing ----------------------------------------------

def test_full_hit_refcounts_and_cow():
    c = _cache()
    toks = list(range(8))
    c.alloc_sequence(1, toks)
    c.commit_prefill(1, 8)
    assert c.alloc_sequence(2, toks) == 7        # full hit capped at n-1
    assert c.shared_blocks == 2
    assert [c.ref_count(b) for b in c.block_table(1)] == [2, 2]
    c.ensure_writable(2, 7, 8)                   # capped token -> COW
    assert c.cow_copies == 1 and c.shared_blocks == 1
    assert c.block_table(2)[1] != c.block_table(1)[1]
    assert c.drain_copies() == [(c.block_table(1)[1], c.block_table(2)[1])]
    c.free_sequence(1)
    c.free_sequence(2)
    c.assert_quiesced()


def test_partial_hit_uncommitted_and_disabled():
    c = _cache()
    a = list(range(8))
    c.alloc_sequence(1, a)
    assert c.alloc_sequence(9, a) == 0           # nothing committed yet
    c.commit_prefill(1, 8)
    assert c.alloc_sequence(2, a[:4] + [50, 51, 52, 53]) == 4
    assert c.block_table(2)[0] == c.block_table(1)[0]
    assert c.ref_count(c.block_table(2)[0]) == 2
    assert c.ref_count(c.block_table(2)[1]) == 1
    off = _cache(enable_prefix_cache=False)
    off.alloc_sequence(1, a)
    off.commit_prefill(1, 8)
    assert off.alloc_sequence(2, a) == 0 and off.shared_blocks == 0


def test_cached_free_blocks_revive_then_evict_on_reuse():
    c = _cache()
    toks = list(range(8))
    c.alloc_sequence(1, toks)
    c.commit_prefill(1, 8)
    c.free_sequence(1)
    c.assert_quiesced()                          # free, yet still cached
    assert c.alloc_sequence(2, toks) == 7
    assert c.cached_free_revivals == 2
    c = _cache(num_blocks=5)                     # 4 usable blocks
    c.alloc_sequence(1, toks)
    c.commit_prefill(1, 8)
    c.free_sequence(1)
    c.alloc_sequence(2, [40] * 16)               # consumes all 4 blocks
    c.free_sequence(2)
    assert c.alloc_sequence(3, toks) == 0        # cached content is gone
    assert c.cached_free_evictions == 2


def test_free_sequence_cancels_pending_cow_copies():
    c = _cache()
    toks = list(range(8))
    c.alloc_sequence(1, toks)
    c.commit_prefill(1, 8)
    c.alloc_sequence(2, toks)
    c.alloc_sequence(3, toks)
    c.ensure_writable(2, 7, 8)
    c.ensure_writable(3, 7, 8)
    dst3 = c.block_table(3)[1]
    c.free_sequence(2)
    assert c.drain_copies() == [(c.block_table(1)[1], dst3)]
    c.free_sequence(1)
    c.free_sequence(3)
    c.assert_quiesced()


def test_readmission_alloc_can_skip_stats():
    c = _cache()
    toks = list(range(8))
    c.alloc_sequence(1, toks)
    c.commit_prefill(1, 8)
    c.free_sequence(1)
    assert c.alloc_sequence(2, toks, count_stats=False) == 7
    assert (c.hit_tokens, c.prompt_tokens) == (0, 8)


def test_plan_drops_chunk_of_request_preempted_mid_plan():
    cache = _cache(num_blocks=4)                 # 3 usable blocks
    sched = Scheduler(cache, max_batch_size=2, max_prefill_tokens=64)
    prefix = list(range(8))
    cache.alloc_sequence(99, prefix)
    cache.commit_prefill(99, 8)
    cache.free_sequence(99)
    b = Request(prompt=prefix + [90, 91, 92, 93])
    cx = Request(prompt=prefix)
    sched.add(b)
    sched.add(cx)
    rows = sched.next_batch()
    assert [w.req for w in rows] == [cx]
    assert b in sched.waiting and b.prefill_pos == 0


# -- engine-level: sharing and chunking are invisible -----------------------

SYSTEM = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8]          # 3 full blocks
TAILS = [[21, 22, 23, 24], [31, 32, 33, 34], [41, 42, 43, 44]]
PROMPTS = [SYSTEM + t for t in TAILS]
LONG = list(range(1, 25))


def test_shared_prefix_identical_to_unshared(models):
    tm, _, _ = models
    base = [_engine(tm, enable_prefix_cache=False).generate(
        [p], max_new_tokens=8)[0] for p in PROMPTS]
    shared = _engine(tm)
    got = [shared.generate([p], max_new_tokens=8)[0] for p in PROMPTS]
    assert got == base
    assert shared.cache.hit_tokens >= 2 * len(SYSTEM)
    assert shared.prefill_tokens_computed < sum(map(len, PROMPTS))
    shared.cache.assert_quiesced()


def test_duplicate_prompt_full_hit_triggers_cow(models):
    """An identical prompt arriving while the original runs rides its
    live blocks; the capped last token COWs a shared block, and both
    streams equal the solo run and the JAX engine's."""
    tm, jm, jvars = models
    p = SYSTEM + TAILS[0]

    def run(eng):
        r1 = eng.add_request(p, max_new_tokens=8)
        for _ in range(3):
            eng.step()
        r2 = eng.add_request(p, max_new_tokens=8)
        eng.run()
        return r1, r2

    eng = _engine(tm)
    r1, r2 = run(eng)
    solo = _engine(tm).generate([p], max_new_tokens=8)[0]
    assert r1.generated == solo and r2.generated == solo
    assert r2.cached_tokens == 15 and eng.cache.cow_copies >= 1
    eng.cache.assert_quiesced()
    jr1, jr2 = run(JaxServeEngine(jm, jvars, max_batch_size=4, block_size=4,
                                  num_blocks=64, registry=JaxRegistry()))
    assert (r1.generated, r2.generated) == (jr1.generated, jr2.generated)


def test_concurrent_sharing_batch(models):
    tm, _, _ = models
    base = _engine(tm, enable_prefix_cache=False).generate(
        PROMPTS, max_new_tokens=8)
    eng = _engine(tm, max_batch_size=2)
    assert eng.generate(PROMPTS, max_new_tokens=8) == base
    assert eng.cache.hit_tokens > 0
    eng.cache.assert_quiesced()


def test_preemption_with_sharing_keeps_siblings_intact(models):
    tm, _, _ = models
    prompts = [[7, 3, 7, 3] + t for t in TAILS]
    want = _engine(tm, max_batch_size=3).generate(prompts, max_new_tokens=12)
    tight = _engine(tm, max_batch_size=3, num_blocks=9)
    assert tight.generate(prompts, max_new_tokens=12) == want
    assert sum(r.preemptions for r in tight.finished.values()) > 0
    assert tight.cache.prompt_tokens == sum(map(len, prompts))
    tight.cache.assert_quiesced()


def test_mid_plan_preemption_end_to_end(models):
    tm, _, _ = models
    prefix = SYSTEM[:8]
    prompts = [prefix + [21, 22, 23, 24], [40 + i for i in range(12)],
               prefix]
    solo = [_engine(tm).generate([p], max_new_tokens=4)[0] for p in prompts]
    eng = _engine(tm, max_batch_size=3, num_blocks=7)
    eng.generate([prefix], max_new_tokens=2)     # seed cached-free prefix
    assert eng.generate(prompts, max_new_tokens=4) == solo
    assert sum(r.preemptions for r in eng.finished.values()) >= 1
    eng.cache.assert_quiesced()


@pytest.mark.parametrize("budget", [4, 7, 16])
def test_chunked_prefill_identical_to_monolithic(models, budget):
    tm, _, _ = models
    mono = _engine(tm).generate([LONG], max_new_tokens=8)
    eng = _engine(tm, max_prefill_tokens=budget)
    assert eng.generate([LONG], max_new_tokens=8) == mono
    assert eng.max_chunk_tokens <= budget
    eng.cache.assert_quiesced()


def test_chunked_prefill_interleaves_decode(models, capsys):
    tm, _, _ = models
    eng = _engine(tm, max_prefill_tokens=4)
    eng.add_request([5, 9, 2], max_new_tokens=10)
    eng.add_request(LONG, max_new_tokens=4)
    eng.run()
    events = [json.loads(line) for line in
              capsys.readouterr().out.strip().splitlines()
              if line.startswith('{"evt"')]
    prefills = [i for i, e in enumerate(events)
                if e["evt"] == "serve_prefill"]
    decodes = [i for i, e in enumerate(events) if e["evt"] == "serve_decode"]
    assert len(prefills) >= 4
    assert all(events[i]["tokens"] <= 4 for i in prefills)
    assert any(prefills[0] < d < prefills[-1] for d in decodes)
