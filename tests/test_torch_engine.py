"""The port's ServeEngine (device="cpu") against the JAX ServeEngine.

Both engines serve the same weights (numpy-made, JAX layout) and the
same prompts with the same configuration; token streams must be
IDENTICAL, greedy and sampled: the scheduler and cache are host Python
ported line for line, sampling is numpy keyed on (seed, position), and
the CPU step agrees with JAX's to ~1e-6. The port's own invariants are
checked too: batched == solo streams, a quiesced cache after a drain,
and one step-operand shape signature across mixed traffic (the port's
form of the JAX engine's one-compile rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.engine import ServeEngine as JaxServeEngine
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu_torch.engine import (CacheExhausted, PagedKVCache, Request,
                                     Scheduler, ServeEngine, serve_metadata)
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.testing import (OOV_DIMS, OOV_ENGINE,
                                      OOV_KERNEL_STREAMS, OOV_NEW_TOKENS,
                                      OOV_PROMPTS, OOV_VOCAB,
                                      causal_lm_tree)

VOCAB = 61
DIMS = dict(model_dim=16, num_heads=4, num_layers=2, ffn_dim=32,
            num_kv_heads=2)
ENGINE = dict(max_batch_size=4, block_size=4, num_blocks=64,
              max_prefill_tokens=8, tile_q=4)

PREFIX = [3, 17, 29, 41, 5, 9, 13, 50]
WAVE1 = [[5, 9, 2], [7, 1, 1, 3, 8], PREFIX + list(range(20, 32)), [4]]
WAVE2 = [PREFIX + [1, 2, 3], PREFIX + [33, 34, 35, 36, 37, 38, 39]]


@pytest.fixture(scope="module")
def models():
    # the JAX initializers' distributions: at this size they give
    # varied greedy streams (larger embeddings make the tied head echo
    # the last token)
    tree = causal_lm_tree(0, VOCAB, **DIMS)
    jm = JaxCausalLM(VOCAB, dropout=0.0, max_len=64, **DIMS)
    tm = CausalLM(VOCAB, dropout=0.0, max_len=64, device="cpu", **DIMS)
    load_jax_params(tm, tree)
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm


def _port(tm, **kw):
    return ServeEngine(tm, device="cpu", registry=MetricsRegistry(),
                       **dict(ENGINE, **kw))


def _jax(jm, jvars, **kw):
    from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    return JaxServeEngine(jm, jvars, registry=JaxRegistry(),
                          **dict(ENGINE, **kw))


def _two_waves(engine, n=8, **req):
    out = engine.generate(WAVE1, max_new_tokens=n, **req)
    return out + engine.generate(WAVE2, max_new_tokens=n, **req)


def test_greedy_streams_match_jax_engine(models):
    """Wave 1 has a prompt longer than the chunk budget (chunked over
    three steps); wave 2 hits the prefix cache. Streams and the cache
    bookkeeping equal the JAX engine's."""
    jm, jvars, tm = models
    port, ref = _port(tm), _jax(jm, jvars)
    got, want = _two_waves(port), _two_waves(ref)
    assert got == want
    assert port.cache.hit_tokens > 0
    for key in ("hit_tokens", "prompt_tokens", "cow_copies", "steps",
                "prefill_tokens_computed", "max_chunk_tokens"):
        assert port.stats()[key] == ref.stats()[key], key


def test_sampled_streams_match_jax_engine(models):
    jm, jvars, tm = models
    kw = dict(temperature=0.8, top_k=8, seed=123)
    assert _two_waves(_port(tm), **kw) == _two_waves(_jax(jm, jvars), **kw)


def test_full_vocab_sampling_and_eos_match_jax_engine(models):
    jm, jvars, tm = models
    kw = dict(temperature=1.3, seed=7, eos_id=11)
    got = _port(tm).generate(WAVE1, max_new_tokens=12, **kw)
    assert got == _jax(jm, jvars).generate(WAVE1, max_new_tokens=12, **kw)


def test_preemption_streams_match_jax_engine(models):
    """A pool too small for every running request preempts by
    recompute; the port preempts the same victims and streams the same
    tokens as JAX."""
    jm, jvars, tm = models
    prompts = [list(range(1 + i, 9 + i)) for i in range(4)]
    port, ref = _port(tm, num_blocks=12), _jax(jm, jvars, num_blocks=12)
    got = port.generate(prompts, max_new_tokens=12)
    assert got == ref.generate(prompts, max_new_tokens=12)
    assert port.obs.get("ptpu_sched_preemptions_total").value > 0
    port.cache.assert_quiesced()


# the second prompt holds an id >= V
OOV_BATCH = [[5, 9, 2], [7, 1, VOCAB, 3]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_out_of_vocabulary_ids_match_jax_fill(dtype):
    """The port's Embedding against JAX's (`jnp.take` in fill mode): ids
    in [-V, 0) count from the end, ids outside [-V, V) give a NaN row
    in the output dtype (compared NaN-equal, exactly), and a NaN row
    sends the table no gradient."""
    from paddle_tpu.nn.layers import Embedding as JaxEmbedding
    from paddle_tpu_torch.nn.layers import Embedding
    ids = np.array([[0, 5, VOCAB - 1, VOCAB],
                    [VOCAB + 5, -1, -VOCAB, -VOCAB - 1]], np.int32)
    coef = np.random.default_rng(0).standard_normal(
        ids.shape + (8,)).astype(np.float32)
    jm = JaxEmbedding(VOCAB, 8, dtype=getattr(jnp, dtype))
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1,), jnp.int32))["params"]

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(ids)).astype(jnp.float32)
        return jnp.sum(jnp.where(jnp.isnan(out), 0.0, out) * coef), out

    (_, want), grad = jax.value_and_grad(loss, has_aux=True)(params)
    tm = Embedding(VOCAB, 8, dtype=getattr(torch, dtype), device="cpu")
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.array(params["weight"])))
    out = tm(torch.from_numpy(ids).long())
    assert out.dtype == getattr(torch, dtype)
    got = out.float()
    assert got.isnan().any(-1).tolist() == [[False, False, False, True],
                                            [True, False, False, True]]
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               rtol=0, atol=0, equal_nan=True)
    torch.where(got.isnan(), 0.0, got).mul(
        torch.from_numpy(coef)).sum().backward()
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               np.asarray(grad["weight"]), rtol=1e-6,
                               atol=1e-6)


def test_out_of_vocabulary_prompt_matches_jax_engine(models):
    """A prompt with an id >= V: its NaN logits sample token 0 as the
    JAX engine's do, the other request of the batch is unharmed, both
    finish, and nothing stays running or holds a block."""
    jm, jvars, tm = models
    port = _port(tm)
    got = port.generate(OOV_BATCH, max_new_tokens=4)
    assert got == _jax(jm, jvars).generate(OOV_BATCH, max_new_tokens=4)
    assert got == [[59, 59, 33, 43], [0, 0, 0, 0]]
    assert not port.scheduler.running and not port.scheduler.waiting
    port.cache.assert_quiesced()


@pytest.mark.parametrize("path", ["reference", "interpret"])
def test_blocks_reused_after_a_nan_request_match_jax_engine(path,
                                                           monkeypatch):
    """testing.OOV_PROMPTS: the NaN request's KV blocks go back to a
    5-block pool and later requests reuse them. Through the JAX engine's
    XLA reference (its CPU default) a stale NaN in a table entry past a
    row's context meets p = 0 in P.V (0 * NaN) and collapses some later
    streams to token 0; the port's plain version streams exactly the
    same. Through
    its Pallas kernel (interpret mode) the JAX engine streams
    testing.OOV_KERNEL_STREAMS, which the port's CUDA kernel must stream
    on the card (test_torch_kernels_gpu.py)."""
    from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    tree = causal_lm_tree(0, OOV_VOCAB, **OOV_DIMS)
    monkeypatch.setenv("PTPU_PAGED_KERNEL", path)
    ref = JaxServeEngine(
        JaxCausalLM(OOV_VOCAB, dropout=0.0, max_len=64, **OOV_DIMS),
        jax.tree_util.tree_map(jnp.asarray, tree), registry=JaxRegistry(),
        **OOV_ENGINE)
    want = [ref.generate(p, max_new_tokens=OOV_NEW_TOKENS)
            for p in OOV_PROMPTS]
    if path == "interpret":
        assert want == OOV_KERNEL_STREAMS
        return
    tm = CausalLM(OOV_VOCAB, dropout=0.0, max_len=64, device="cpu",
                  **OOV_DIMS)
    load_jax_params(tm, tree)
    port = ServeEngine(tm, device="cpu", registry=MetricsRegistry(),
                       **OOV_ENGINE)
    assert [port.generate(p, max_new_tokens=OOV_NEW_TOKENS)
            for p in OOV_PROMPTS] == want
    assert want != OOV_KERNEL_STREAMS
    assert not port.scheduler.running
    port.cache.assert_quiesced()

def test_batched_equals_solo(models):
    _, _, tm = models
    batched = _port(tm).generate(WAVE1, max_new_tokens=8)
    solo = [_port(tm).generate([p], max_new_tokens=8)[0] for p in WAVE1]
    assert batched == solo


def test_quiesced_and_one_step_shape_across_mixed_traffic(models):
    _, _, tm = models
    eng = _port(tm)
    _two_waves(eng)
    eng.add_request(list(range(1, 30)), max_new_tokens=4)   # 4 chunks
    eng.add_request([5, 9], max_new_tokens=6)               # decode rider
    eng.run()
    assert len(eng.step_shapes) == 1
    assert eng.obs.get("ptpu_engine_compiles").value == 1
    eng.cache.assert_quiesced()
    assert eng.obs.get("ptpu_serve_ttft_ms").count == len(WAVE1) + \
        len(WAVE2) + 2


def test_cancel_midflight_frees_blocks(models):
    _, _, tm = models
    eng = _port(tm)
    keep = eng.add_request([5, 9, 2], max_new_tokens=6)
    drop = eng.add_request(PREFIX + [1, 2, 3], max_new_tokens=6)
    eng.step()
    eng.step()
    assert eng.cancel(drop) and not eng.cancel(drop)
    eng.run()
    assert drop.finish_reason == "cancelled"
    assert eng.finished[keep.req_id].generated == \
        _port(tm).generate([[5, 9, 2]], max_new_tokens=6)[0]
    eng.cache.assert_quiesced()


def test_prefill_budget_validated(models):
    _, _, tm = models
    with pytest.raises(ValueError, match="max_prefill_tokens"):
        _port(tm, max_prefill_tokens=0)
    big = _port(tm, max_prefill_tokens=10_000)
    assert big.scheduler.max_prefill_tokens == big.max_seq_len
    assert big.flat_tokens == _port(tm, max_prefill_tokens=64).flat_tokens


def test_serve_metadata_matches_jax(models):
    from paddle_tpu.engine.engine import serve_metadata as jax_meta
    jm, _, tm = models
    assert serve_metadata(tm) == jax_meta(jm)


def test_engine_without_device_needs_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, _, tm = models
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServeEngine(tm, **ENGINE)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PagedKVCache(num_layers=1, num_blocks=4, block_size=4,
                     num_kv_heads=2, head_dim=8)


# -- host bookkeeping (mirrors tests/test_engine.py) -------------------------

def _cache(num_blocks=64, block_size=4):
    return PagedKVCache(num_layers=1, num_blocks=num_blocks,
                        block_size=block_size, num_kv_heads=2, head_dim=8,
                        device="cpu", registry=MetricsRegistry())


def test_cache_alloc_free_and_append():
    c = _cache(num_blocks=9)
    assert c.free_blocks == 8
    c.alloc_sequence(1, [1] * 5)
    c.alloc_sequence(2, [2] * 4)
    assert c.used_blocks == 3
    assert c.free_sequence(1) == 2 and c.free_sequence(2) == 1
    c.alloc_sequence(7, [1, 2, 3, 4])
    slot = c.append_token(7)
    assert slot % 4 == 0 and c.append_token(7) == slot
    c.advance(7, 9)
    assert c.seq_len(7) == 5
    assert 0 not in c.block_table(7)
    assert c.padded_table(7, 4)[-2:] == [0, 0]
    assert all(float(p.abs().sum()) == 0 for kv in c.pools for p in kv)


def test_cache_exhaustion_and_prefix_cow():
    c = _cache(num_blocks=3)
    c.alloc_sequence(1, [1] * 4)
    with pytest.raises(CacheExhausted):
        c.alloc_sequence(2, [2] * 12)
    assert c.free_blocks == 1
    c = _cache()
    c.alloc_sequence(1, [1, 2, 3, 4, 5])
    c.commit_prefill(1, 5)
    # a full-prompt hit is capped at n-1 and COWs the shared block
    assert c.alloc_sequence(2, [1, 2, 3, 4]) == 3
    c.ensure_writable(2, 3, 4)
    assert len(c.drain_copies()) == 1 and c.cow_copies == 1


def test_scheduler_fifo_chunks_and_preempt():
    c = _cache()
    s = Scheduler(c, max_batch_size=2, max_prefill_tokens=8)
    for p in ([1, 2, 3], [4, 5], [6]):
        s.add(Request(prompt=list(p)))
    rows = s.next_batch()
    assert [(w.start, w.length, w.decode) for w in rows] == \
        [(0, 3, False), (0, 2, False)]
    assert [w.length for w in s.next_batch()] == [1, 1]
    c2 = _cache()
    s2 = Scheduler(c2, max_batch_size=2, max_prefill_tokens=8)
    s2.add(Request(prompt=list(range(20))))
    assert [(w.start, w.length) for w in
            (s2.next_batch()[0] for _ in range(3))] == [(0, 8), (8, 8),
                                                        (16, 4)]
    r = s2.running[0]
    r.generated = [9, 8]
    s2.preempt(r)
    assert r.prompt[-2:] == [9, 8] and r.preempt_carry == 2
    assert s2.waiting[0] is r and c2.free_blocks == 63


def test_scheduler_victim_and_liveness():
    s = Scheduler(_cache(), max_batch_size=4)
    tight = Request(prompt=[1], deadline=10.0)
    loose = Request(prompt=[2], deadline=99.0)
    none_ = Request(prompt=[3])
    s.running = [tight, loose, none_]
    assert s._pick_victim(tight) is none_
    s.running = [tight, loose]
    assert s._pick_victim(loose) is tight
    s2 = Scheduler(_cache(num_blocks=4), max_batch_size=2)
    s2.add(Request(prompt=list(range(16))))
    with pytest.raises(CacheExhausted, match="never"):
        s2.next_batch()
