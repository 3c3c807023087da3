"""The port's speculative decoding and parallel sampling against the JAX
package's (mirrors tests/test_spec_decode.py; its front-end class waits
for the port's serve layer).

- the drafter: the same proposals on adversarial histories, and on
  seeded random ones the port's `NgramDrafter` proposes what JAX's does;
- the cache: `fork_sequence` and `reserve_slots` keep their semantics
  (shared blocks, copy-on-write on divergence, all-or-nothing
  reservation), and a scripted sequence of them gives JAX's tables,
  slots and refcounts; a fork over int8 direct-read slots pins and
  unpins them;
- the engine: speculative streams equal the plain engine's (greedy,
  temperature, an always-wrong drafter, a pool too tight for a window)
  AND the JAX speculative engine's streams with its drafted / accepted
  / rejected counts and step count; the staged operands of a
  speculating step equal JAX's `_step_fn` operands (last_idx [B, 5]);
  n-best candidates equal solo runs under seed + i and JAX's
  candidates; a cancelled group leaves the pool quiesced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.engine import NgramDrafter as JaxNgramDrafter
from paddle_tpu.engine import PagedKVCache as JaxPagedKVCache
from paddle_tpu.engine import ServeEngine as JaxServeEngine
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.engine import (CacheExhausted, NgramDrafter,
                                     PagedKVCache, ServeEngine)
from paddle_tpu_torch.engine.step_graph import OPERANDS
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry

VOCAB = 61
SPEC_COUNTERS = ("ptpu_spec_drafted_tokens_total",
                 "ptpu_spec_accepted_tokens_total",
                 "ptpu_spec_rejected_tokens_total")
# a prompt whose continuation the model tends to copy: lookup-friendly
REPEATY = [1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2, 3]


@pytest.fixture(scope="module")
def models():
    """tests/test_spec_decode.py's fixture model, its JAX init weights
    loaded into the port's CausalLM."""
    jm = JaxCausalLM(vocab=VOCAB, model_dim=16, num_heads=4, num_layers=2,
                     ffn_dim=32, dropout=0.0, max_len=64)
    jvars = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tm = CausalLM(VOCAB, model_dim=16, num_heads=4, num_layers=2,
                  ffn_dim=32, dropout=0.0, max_len=64, device="cpu")
    load_jax_params(tm, jax.device_get(jvars))
    return jm, jvars, tm


def _kw(**kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_prefill_tokens", 32)
    kw.setdefault("tile_q", 4)
    return kw


def _engine(models, **kw):
    return ServeEngine(models[2], device="cpu", registry=MetricsRegistry(),
                       **_kw(**kw))


def _jax_engine(models, **kw):
    return JaxServeEngine(models[0], models[1], registry=JaxRegistry(),
                          **_kw(**kw))


def _spec_counts(eng):
    return [eng.obs.get(name).value for name in SPEC_COUNTERS]


def _same_as_jax(models, scenario, **kw):
    """Run `scenario(engine)` on the port's engine and on the JAX engine
    with the same options: equal outputs, spec counters and steps, one
    step shape. Returns the port's (engine, outputs)."""
    port, ref = _engine(models, **kw), _jax_engine(models, **kw)
    got, want = scenario(port), scenario(ref)
    assert got == want
    assert _spec_counts(port) == _spec_counts(ref)
    assert port.steps == ref.steps
    assert len(port.step_shapes) == 1 and port.step_graph.compiles == 1
    assert ref._step_fn._cache_size() == 1
    return port, got


# -- drafter ---------------------------------------------------------------

class TestNgramDrafter:
    def test_no_match_proposes_nothing(self):
        d = NgramDrafter(k=4, max_ngram=3)
        assert d.propose([1, 2, 3, 4, 5, 6]) == []
        assert d.propose([7]) == []
        assert d.propose([]) == []

    def test_full_match_proposes_continuation(self):
        d = NgramDrafter(k=4, max_ngram=3)
        assert d.propose([1, 2, 3, 4, 5, 6, 7, 1, 2, 3]) == [4, 5, 6, 7]

    def test_repeated_ngram_picks_most_recent(self):
        d = NgramDrafter(k=2, max_ngram=2)
        assert d.propose([1, 2, 9, 1, 2, 8, 1, 2]) == [8, 1]

    def test_longer_ngram_wins(self):
        d = NgramDrafter(k=1, max_ngram=3)
        assert d.propose([5, 1, 2, 7, 0, 1, 2, 6, 5, 1, 2]) == [7]

    def test_full_window_beats_tail_flush_match(self):
        d = NgramDrafter(k=4, max_ngram=3)
        assert d.propose([5, 6, 7] + [20] * 8) == [20, 20, 20, 20]
        d2 = NgramDrafter(k=8, max_ngram=2)
        assert d2.propose([1, 2, 9, 9, 1, 2]) == [9, 9, 1, 2]

    def test_cap_respected(self):
        d = NgramDrafter(k=8, max_ngram=1)
        hist = [3, 4, 5, 6, 3]
        assert d.propose(hist, max_tokens=2) == [4, 5]
        assert d.propose(hist, max_tokens=0) == []

    def test_validation(self):
        with pytest.raises(ValueError):
            NgramDrafter(k=0)
        with pytest.raises(ValueError):
            NgramDrafter(k=2, max_ngram=1, min_ngram=2)

    @pytest.mark.parametrize("k,max_ngram,min_ngram",
                             [(4, 3, 1), (2, 2, 2), (6, 4, 1)])
    def test_proposals_equal_jax(self, k, max_ngram, min_ngram):
        """Seeded random histories over a small alphabet (so n-grams
        repeat), with and without a cap: the same drafts as JAX's."""
        rng = np.random.default_rng(k * 10 + max_ngram)
        port = NgramDrafter(k, max_ngram, min_ngram)
        ref = JaxNgramDrafter(k, max_ngram, min_ngram)
        for _ in range(200):
            hist = rng.integers(0, 5, rng.integers(0, 30)).tolist()
            cap = [None, int(rng.integers(0, k + 2))][int(rng.integers(2))]
            assert port.propose(hist, cap) == ref.propose(hist, cap)


# -- cache fork / reservation ----------------------------------------------

def _cache(cls=PagedKVCache, **kw):
    kw.setdefault("num_layers", 1)
    kw.setdefault("num_blocks", 16)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_kv_heads", 1)
    kw.setdefault("head_dim", 4)
    if cls is PagedKVCache:
        kw.setdefault("device", "cpu")
        kw.setdefault("registry", MetricsRegistry())
    else:
        kw.setdefault("registry", JaxRegistry())
    return cls(**kw)


class TestCacheForkAndReserve:
    def test_fork_shares_all_blocks(self):
        c = _cache()
        c.alloc_sequence(0, list(range(10)))        # 3 blocks
        used = c.used_blocks
        c.fork_sequence(0, 1)
        assert c.used_blocks == used                # zero new blocks
        assert c.block_table(1) == c.block_table(0)
        for b in c.block_table(0):
            assert c.ref_count(b) == 2
        with pytest.raises(ValueError):
            c.fork_sequence(0, 1)                   # dst exists

    def test_free_fork_only_drops_exclusive_blocks(self):
        c = _cache()
        c.alloc_sequence(0, list(range(10)))
        c.fork_sequence(0, 1)
        c.reserve_slots(1, 1)
        c.advance(1, 99)
        forked_tail = c.block_table(1)[-1]
        assert c.ref_count(forked_tail) == 1        # private copy
        shared = c.block_table(0)
        c.free_sequence(1)
        assert c.block_table(0) == shared
        for b in shared:
            assert c.ref_count(b) == 1
        c.free_sequence(0)
        assert c.used_blocks == 0
        c.assert_quiesced()

    def test_fork_divergence_cows_shared_tail(self):
        c = _cache()
        c.alloc_sequence(0, list(range(6)))         # tail block half full
        tail = c.block_table(0)[-1]
        c.fork_sequence(0, 1)
        c.reserve_slots(1, 1)
        assert c.block_table(1)[-1] != tail
        assert c.block_table(0)[-1] == tail
        assert c.ref_count(tail) == 1
        assert c.drain_copies() != []               # device copy queued

    def test_reserve_slots_all_or_nothing(self):
        c = _cache(num_blocks=4)                    # 3 usable blocks
        c.alloc_sequence(0, list(range(8)))         # uses 2
        table = list(c.block_table(0))
        free = c.free_blocks
        with pytest.raises(CacheExhausted):
            c.reserve_slots(0, 6)                   # needs 2 fresh, 1 free
        assert c.block_table(0) == table
        assert c.free_blocks == free
        assert len(c.reserve_slots(0, 4)) == 4

    def test_reserve_slots_spans_blocks(self):
        c = _cache()
        c.alloc_sequence(0, list(range(3)))
        slots = c.reserve_slots(0, 3)               # 3..5: crosses a block
        bs = c.block_size
        assert [s % bs for s in slots] == [3, 0, 1]
        for j, s in enumerate(slots):
            assert s == c.slot_of(0, 3 + j)

    def test_fork_and_reserve_script_equals_jax(self):
        """The same script of allocations, forks, windows, advances and
        frees on both caches: equal tables, slots, refcounts, COW copies
        and free counts after every operation, and the same exhaustion
        points."""
        caches = (_cache(num_blocks=12), _cache(JaxPagedKVCache,
                                                num_blocks=12))

        def state(c, ids):
            return ([c.block_table(i) for i in ids],
                    sorted((b, c.ref_count(b)) for i in ids
                           for b in c.block_table(i)),
                    c.free_blocks, c.drain_copies())

        def run(c):
            out = [c.alloc_sequence(0, list(range(10)))]
            c.commit_prefill(0, 10)
            c.fork_sequence(0, 1)
            c.fork_sequence(0, 2)
            out.append(state(c, (0, 1, 2)))
            for seq, count in ((1, 3), (2, 5), (0, 2), (1, 6), (2, 9)):
                try:
                    out.append(c.reserve_slots(seq, count))
                except CacheExhausted:
                    out.append("exhausted")
                for t in range(min(count, 2)):
                    c.advance(seq, 40 + t)
                out.append(state(c, (0, 1, 2)))
            c.free_sequence(1)
            out.append(state(c, (0, 2)))
            for seq in (0, 2):
                c.free_sequence(seq)
            c.assert_quiesced()
            return out

        assert run(caches[0]) == run(caches[1])

    def test_fork_pins_and_unpins_direct_read_slots(self):
        """A fork of a table with int8 direct-read entries bumps each
        slot's pin; freeing either sequence drops one (the fork half of
        tests/test_kvcompress.py:352)."""
        c = _cache(compress_blocks=8, num_kv_heads=2, head_dim=8)
        toks = list(range(10))
        c.alloc_sequence(1, toks)
        c.commit_prefill(1, 10)
        c.free_sequence(1)
        c.step_now = 10
        assert c.compress_cold() == 2
        c.drain_compress()
        for s, base in ((2, 100), (3, 200), (4, 300), (5, 400)):
            c.alloc_sequence(s, [base + i for i in range(16)])
            c.commit_prefill(s, 16)
            c.free_sequence(s)
        assert c.alloc_sequence(9, toks) == 8
        table = c.block_table(9)
        assert table[0] < 0 and table[1] < 0 and table[2] >= 0
        slots = {-b - 1 for b in table[:2]}
        c.fork_sequence(9, 10)
        assert all(c._cslot_refs[s] == 2 for s in slots)
        c.free_sequence(9)
        assert all(c._cslot_refs[s] == 1 for s in slots)
        c.free_sequence(10)
        assert not c._cslot_refs
        c.drain_compress()
        c.assert_quiesced()


# -- speculative decode: identity + rollback -------------------------------

class _WrongDrafter:
    """Always proposes k tokens the model rejects (the last token + 1,
    mod vocab): every window takes the rejection-rollback path."""

    def __init__(self, k=3):
        self.k = k

    def propose(self, tokens, max_tokens=None):
        cap = self.k if max_tokens is None else min(self.k, max_tokens)
        if cap < 1:
            return []
        return [(tokens[-1] + 1) % VOCAB] * cap


def _gen(prompts, n_new, **req):
    return lambda eng: eng.generate(prompts, max_new_tokens=n_new, **req)


class TestSpeculativeDecode:
    def test_greedy_identical_to_plain_decode_and_jax(self, models):
        prompts = [list(REPEATY), [9, 8, 7, 9, 8, 7, 9, 8],
                   [4, 4, 4, 4, 4, 4]]
        refs = _engine(models).generate(prompts, max_new_tokens=16)
        spec, outs = _same_as_jax(models, _gen(prompts, 16), spec_k=4)
        assert outs == refs
        assert spec._m_spec_drafted.value > 0
        assert spec._m_spec_accepted.value > 0

    def test_greedy_identical_with_chunked_prefill(self, models):
        prompts = [list(REPEATY) * 2, [2, 3] * 8]   # > chunk budget of 8
        refs = _engine(models, max_prefill_tokens=8).generate(
            prompts, max_new_tokens=12)
        _, outs = _same_as_jax(models, _gen(prompts, 12),
                               max_prefill_tokens=8, spec_k=3)
        assert outs == refs

    def test_temperature_identical(self, models):
        ref = _engine(models).generate([list(REPEATY)], max_new_tokens=16,
                                       temperature=0.7, seed=11)
        _, outs = _same_as_jax(
            models, _gen([list(REPEATY)], 16, temperature=0.7, seed=11),
            spec_k=4)
        assert outs == ref

    def test_rejection_rollback_exactness(self, models):
        """An always-wrong drafter rolls back every window: streams equal
        plain decode, every drafted token counts as rejected."""
        prompts = [list(REPEATY), [6, 5, 4, 3, 2, 1]]
        refs = _engine(models).generate(prompts, max_new_tokens=14)
        port, ref = (_engine(models, drafter=_WrongDrafter(k=3)),
                     _jax_engine(models, drafter=_WrongDrafter(k=3)))
        assert port.spec_k == 3
        got = port.generate(prompts, max_new_tokens=14)
        assert got == refs == ref.generate(prompts, max_new_tokens=14)
        assert _spec_counts(port) == _spec_counts(ref)
        assert port._m_spec_rejected.value > 0
        assert port._m_spec_accepted.value == 0
        assert port._m_spec_drafted.value == port._m_spec_rejected.value

    def test_one_step_shape_with_speculation_on(self, models):
        """Mixed traffic with speculation on: one step shape, one
        program, and the pool empties."""
        eng = _engine(models, max_prefill_tokens=8, spec_k=4)
        eng.add_request(list(REPEATY) * 2, max_new_tokens=10)
        eng.add_request([1, 2], max_new_tokens=6, temperature=0.5, seed=3)
        for _ in range(4):
            eng.step()
        eng.add_request([8, 8, 8, 8, 8, 8, 8, 8, 8], max_new_tokens=8)
        eng.run()
        assert eng.step_graph.compiles == 1
        assert eng.obs.get("ptpu_engine_compiles").value == 1.0
        assert len(eng.step_shapes) == 1
        assert eng.cache.occupancy() == 0.0
        steps = eng.obs.get("ptpu_serve_step_ms")
        assert steps.labels(kind="spec").count > 0

    def test_speculation_reduces_steps(self, models):
        prompt = [1, 2, 3] * 6
        base = _engine(models)
        ref = base.generate([prompt], max_new_tokens=24)
        spec, outs = _same_as_jax(models, _gen([prompt], 24), spec_k=4)
        assert outs == ref
        assert spec._m_spec_accepted.value > 0
        assert spec.steps < base.steps

    def test_spec_drops_draft_when_pool_tight(self, models):
        """A pool too small for a whole window plans plain decode rows
        instead of preempting: same output, the engine completes."""
        refs = _engine(models).generate([list(REPEATY)], max_new_tokens=16)
        spec, outs = _same_as_jax(models, _gen([list(REPEATY)], 16),
                                  num_blocks=9, spec_k=4)
        assert outs == refs
        assert spec.cache.occupancy() == 0.0

    def test_flat_width_and_last_idx_shape(self, models):
        """The flat width is roundup(budget, tile_q) + B *
        roundup(spec_k + 1, tile_q), as JAX sizes it, and last_idx holds
        spec_len columns; without speculation it keeps its [B] form."""
        for spec_k in (0, 3, 4, 7):
            port = _engine(models, spec_k=spec_k)
            ref = _jax_engine(models, spec_k=spec_k)
            assert port.flat_tokens == ref.flat_tokens
            assert port.spec_len == ref.spec_len == spec_k + 1
            want = (4,) if spec_k == 0 else (4, spec_k + 1)
            assert port.step_graph.operands["last_idx"].shape == want

    def test_staged_operands_equal_jax_step_fn_operands(self, models):
        """Every speculating step's nine operands equal the ones the JAX
        engine passes to its jitted `_step_fn`, last_idx [B, 5] and the
        draft tokens included."""
        port, ref = _engine(models, spec_k=4), _jax_engine(models, spec_k=4)
        got, want = [], []
        run, step_fn = port.step_graph.run, ref._step_fn

        def recorded_port():
            got.append({k: v.copy() for k, v in
                        port.step_graph.operands.items()})
            return run()

        def recorded_jax(variables, tokens, positions, pools, qpools,
                         qscales, *rest):
            want.append({k: np.asarray(a) for k, a in
                         zip(OPERANDS, (tokens, positions, *rest))})
            return step_fn(variables, tokens, positions, pools, qpools,
                           qscales, *rest)
        recorded_jax._cache_size = step_fn._cache_size
        port.step_graph.run, ref._step_fn = recorded_port, recorded_jax
        prompts = [list(REPEATY), [1, 2, 3] * 4, [5, 6]]
        assert (port.generate(prompts, max_new_tokens=12)
                == ref.generate(prompts, max_new_tokens=12))
        assert len(got) == len(want) == port.steps
        for step, (g, w) in enumerate(zip(got, want)):
            for name in OPERANDS:
                assert g[name].dtype == w[name].dtype == np.int32
                np.testing.assert_array_equal(
                    g[name], w[name], err_msg=f"step {step}: {name}")
        assert any((g["last_idx"][:, 1:] != g["last_idx"][:, :1]).any()
                   for g in got)

    def test_negative_spec_k_and_tp_size_raise(self, models):
        with pytest.raises(ValueError, match="spec_k"):
            _engine(models, spec_k=-1)
        with pytest.raises(TypeError, match="tp_size"):
            _engine(models, tp_size=2)


# -- parallel sampling / best-of-n -----------------------------------------

def _group(eng, prompt, n_new, n, **req):
    r = eng.add_request(list(prompt), max_new_tokens=n_new, n=n, **req)
    res = eng.run()
    assert len(r.forks) == n - 1
    return [res[c.req_id] for c in [r] + sorted(r.forks,
                                                key=lambda f: f.cand_index)]


class TestParallelSampling:
    def test_candidates_match_solo_runs_and_jax(self, models):
        prompt = [7, 8, 9, 10, 11, 12, 13, 14]
        port, ref = _engine(models), _jax_engine(models)
        got = _group(port, prompt, 10, 3, temperature=0.8, seed=5)
        assert got == _group(ref, prompt, 10, 3, temperature=0.8, seed=5)
        for i in range(3):
            solo = _engine(models).generate([prompt], max_new_tokens=10,
                                            temperature=0.8, seed=5 + i)
            assert solo[0] == got[i], f"candidate {i}"
        assert port.cache.occupancy() == 0.0
        port.cache.assert_quiesced()

    def test_fork_callbacks_stream_each_candidate(self, models):
        streams = {0: [], 1: [], 2: []}
        eng = _engine(models)
        r = eng.add_request([3, 1, 4, 1, 5], max_new_tokens=6,
                            temperature=0.5, seed=2, n=3,
                            callback=streams[0].append,
                            fork_callback=lambda i: streams[i].append)
        res = eng.run()
        assert streams[0] == res[r.req_id]
        for f in r.forks:
            assert f.parent is r and streams[f.cand_index] == res[f.req_id]

    def test_fork_shares_prompt_blocks(self, models):
        eng = _engine(models)
        r = eng.add_request([3] * 8, max_new_tokens=8, temperature=0.3,
                            seed=1, n=4)
        while not r.forks:
            eng.step()
        assert eng.cache.shared_blocks >= 2         # whole prompt shared
        eng.run()
        assert eng.cache.occupancy() == 0.0

    def test_group_cancel_and_preemption_leak_check(self, models):
        """Occupancy returns to zero after n-best with a mid-flight
        cancel_group AND a pool small enough to preempt candidates."""
        eng = _engine(models, num_blocks=16)
        victim = eng.add_request([5, 6, 7, 8, 5, 6, 7, 8],
                                 max_new_tokens=20, temperature=0.4,
                                 seed=2, n=3)
        for _ in range(5):
            eng.step()
        assert len(victim.forks) == 2
        assert eng.cancel_group(victim) == 3
        survivor = eng.add_request([9, 9, 9, 9, 9, 9, 9, 9],
                                   max_new_tokens=20, temperature=0.4,
                                   seed=7, n=3)
        eng.run()
        assert survivor.finish_reason
        assert all(f.finish_reason for f in survivor.forks)
        assert eng.cache.occupancy() == 0.0
        eng.cache.assert_quiesced()

    def test_cancel_group_before_the_fork(self, models):
        eng = _engine(models, max_prefill_tokens=4)
        r = eng.add_request(list(range(1, 13)), max_new_tokens=5, n=3)
        eng.step()                                  # first chunk only
        assert r.forks == [] and eng.cancel_group(r) == 1
        assert eng.run() == {r.req_id: []}
        eng.cache.assert_quiesced()

    def test_forks_over_int8_direct_reads_quiesce(self, models):
        """A group whose prompt reads an int8-resident prefix in place:
        the forks share the direct-read slots (pins bumped), and after a
        cancelled group and a finished one every pin is dropped."""
        eng = _engine(models, num_blocks=16, kv_compress_blocks=24)
        prefix = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8]
        eng.generate([prefix + [6, 2]], max_new_tokens=4)
        for i in range(4):
            eng.generate([[30 + i] * 16], max_new_tokens=6)
        assert tuple(prefix[:4]) not in eng.cache._index
        cancelled = eng.add_request(prefix + [40, 41], max_new_tokens=8,
                                    temperature=0.6, seed=3, n=3)
        while not cancelled.forks:
            eng.step()
        assert eng.cache.stats()["direct_int8_reads"] > 0
        assert max(eng.cache._cslot_refs.values()) == 3
        assert eng.cancel_group(cancelled) == 3
        assert not eng.cache._cslot_refs
        done = _group(eng, prefix + [42], 6, 2, temperature=0.6, seed=4)
        assert all(len(s) == 6 for s in done)
        eng.cache.assert_quiesced()

    def test_spec_and_forks_compose(self, models):
        """Speculation verifies forked candidates too: a speculating
        group equals a plain group per candidate, and JAX's."""
        prompt = [1, 2, 3, 1, 2, 3, 1, 2]
        base = _group(_engine(models), prompt, 12, 2)
        spec = _engine(models, spec_k=3)
        got = _group(spec, prompt, 12, 2)
        assert got == base == _group(_jax_engine(models, spec_k=3),
                                     prompt, 12, 2)
        assert spec.step_graph.compiles == 1
        assert spec.cache.occupancy() == 0.0

    def test_n_validation(self, models):
        eng = _engine(models)
        with pytest.raises(ValueError):
            eng.add_request([1, 2], n=0)
        with pytest.raises(ValueError):
            eng.add_request([1, 2], n=eng.max_batch_size + 1)


def test_speculative_stream_is_the_dense_greedy_stream(models):
    """A speculating engine's logits are [B, spec_len, V] float32, and
    its greedy stream, most of it accepted drafts, is the dense
    forward's argmax at every position."""
    eng = _engine(models, spec_k=4)
    r = eng.add_request([1, 2, 3] * 4, max_new_tokens=12)
    eng.run()
    assert eng.obs.get("ptpu_spec_accepted_tokens_total").value > 0
    assert eng.step_graph.logits.shape == (4, 5, VOCAB)
    assert eng.step_graph.logits.dtype == torch.float32
    toks = torch.tensor([r.prompt + r.generated])
    with torch.inference_mode():
        dense = models[2](toks)[0, len(r.prompt) - 1:-1]
    assert dense.argmax(-1).tolist() == r.generated
