"""The port's in-device int8 KV tier against the JAX package's.

Mirrors tests/test_kvcompress.py (its host-tier and router cases wait
for those modules: the port has no host tier yet):

- the codec: `quantize_block`/`dequantize_block` are BIT-equal to JAX's,
  and the host quantizer's scales equal the device ones on real content;
- the plain mixed attention matches JAX's mixed reference and its
  Pallas kernel in interpret mode (f32, 1e-5), and a direct int8 read
  equals promote-then-read bit for bit;
- the cache: compression is a copy, not a move; direct-read admission
  pins and unpins slots;
- the engine: on the same weights and traffic the port's engine gives
  the JAX engine's greedy streams and its tier counters
  (compressed_total, promoted_total, direct_reads, compress_hit_tokens,
  compress_spills) exactly, with one step shape throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.engine import PagedKVCache as JaxPagedKVCache
from paddle_tpu.engine import ServeEngine as JaxServeEngine
from paddle_tpu.kernels import paged_attention as jax_paged
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu.quant import int8_compute as jax_quant
from paddle_tpu_torch.engine import PagedKVCache, ServeEngine
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.quant.int8_compute import (QMAX, RQMAX,
                                                 dequantize_block,
                                                 quantize_block,
                                                 quantize_host_int8)
from paddle_tpu_torch.testing import (QUANT_ARGS, RAGGED_ARGS, int8_blocks,
                                      ragged_case)

VOCAB = 61
TOL = dict(atol=1e-5, rtol=1e-5)
COUNTERS = ("compressed_total", "promoted_total", "direct_reads",
            "compress_hit_tokens", "compress_spills")


@pytest.fixture(scope="module")
def models():
    """test_kvcompress.py's fixture model, its JAX init weights loaded
    into the port's CausalLM."""
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
    kw.setdefault("num_blocks", 16)
    return kw


def _engines(models, **kw):
    jm, jvars, tm = models
    return (ServeEngine(tm, device="cpu", registry=MetricsRegistry(),
                        **_kw(**kw)),
            JaxServeEngine(jm, jvars, registry=JaxRegistry(), **_kw(**kw)))


def _same_run(models, scenario, **kw):
    """Run `scenario(engine)` on the port's engine and the JAX engine;
    their outputs and tier counters must be equal. Returns the port's
    (engine, outputs)."""
    port, ref = _engines(models, **kw)
    got, want = scenario(port), scenario(ref)
    assert got == want
    for name in COUNTERS:
        assert getattr(port.cache, name) == getattr(ref.cache, name), name
    assert len(port.step_shapes) == 1
    port.cache.assert_quiesced()
    return port, got


def _cache(cls=PagedKVCache, **kw):
    kw.setdefault("num_layers", 1)
    kw.setdefault("num_blocks", 16)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_kv_heads", 2)
    kw.setdefault("head_dim", 8)
    if cls is PagedKVCache:
        kw.setdefault("device", "cpu")
        kw.setdefault("registry", MetricsRegistry())
    else:
        kw.setdefault("registry", JaxRegistry())
    return cls(**kw)


# -- the codec -------------------------------------------------------------

def test_constants_match_jax():
    assert QMAX == jax_quant.QMAX and RQMAX == jax_quant.RQMAX
    assert np.float32(RQMAX) == np.float32(1.0) / np.float32(QMAX)


@pytest.mark.parametrize("shape", [(4, 2, 8), (3, 4, 2, 8), (8, 16, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_bit_equal_to_jax(shape, dtype):
    """Same numpy input, same int8 payload, same f32 scales, same
    dequantized bytes in f32 and in bf16 — including an all-zero lane
    (the scale floor) and exact .5 ties of x / scale * 127."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    if len(shape) == 4:
        x[1] = 0.0
    x.reshape(-1)[:4] = [1.0, -1.0, 0.5 / 127.0, 1.5 / 127.0]
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(xt.float().numpy()).astype(jdt)    # same values
    qt, st = quantize_block(xt)
    qj, sj = jax_quant.quantize_block(xj)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    back_t = dequantize_block(qt, st, tdt).float().numpy()
    back_j = np.asarray(jax_quant.dequantize_block(qj, sj, jdt)
                        .astype(jnp.float32))
    assert np.array_equal(back_t.view(np.uint32), back_j.view(np.uint32))


def test_device_quant_roundtrip_within_one_step():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 4, 2, 8)).astype(np.float32))
    q, s = quantize_block(x)
    assert q.dtype == torch.int8 and s.shape == (3,)
    back = dequantize_block(q, s, torch.float32)
    bound = s[:, None, None, None] / QMAX + 1e-7
    assert bool(((back - x).abs() <= bound).all())


def test_device_scales_match_host_quantizer():
    rng = np.random.default_rng(1)
    for _ in range(5):
        x = rng.standard_normal((4, 2, 8)).astype(np.float32)
        qd, sd = quantize_block(torch.from_numpy(x)[None])
        qh, sh = quantize_host_int8(x)
        jq, js = jax_quant.quantize_host_int8(x)
        assert float(sd[0]) == sh == js
        assert np.array_equal(qd[0].numpy(), qh)
        assert np.array_equal(qh, jq)


# -- the plain mixed attention ---------------------------------------------

MIXED_CASES = {
    # name: (rows [(context_len, q_len)], H, Hkv, D, block_size, tile_q)
    "mixed": ([(9, 9), (13, 5), (6, 1)], 4, 4, 8, 4, 4),
    "gqa": ([(7, 3), (11, 1), (6, 6), (17, 2)], 8, 2, 16, 4, 4),
    "decode": ([(5, 1), (8, 1), (13, 1)], 4, 2, 8, 4, 2),
}


def _mixed(name, which="odd"):
    rows, h, hkv, d, bs, tq = MIXED_CASES[name]
    case = ragged_case(rows, h, hkv, d, bs, tq, pad_tiles=2, seed=4)
    mixed, promoted, n = int8_blocks(case, which)
    assert n > 0
    return mixed, promoted


def _port(case, **kw):
    args = [torch.from_numpy(case[k]) for k in RAGGED_ARGS]
    quant = {k: torch.from_numpy(case[k]) for k in QUANT_ARGS if k in case}
    return paged.ragged_paged_attention(*args, **quant, **kw).numpy()


def _jax(case, **kw):
    args = [jnp.asarray(case[k]) for k in RAGGED_ARGS]
    quant = {k: jnp.asarray(case[k]) for k in QUANT_ARGS if k in case}
    fn = (jax_paged.ragged_paged_attention if kw
          else jax_paged.ragged_paged_attention_reference)
    return np.asarray(fn(*args, **quant, **kw))


@pytest.mark.parametrize("which", ["odd", "all"])
@pytest.mark.parametrize("name", sorted(MIXED_CASES))
def test_mixed_plain_matches_jax(name, which):
    mixed, _ = _mixed(name, which)
    got = _port(mixed)
    np.testing.assert_allclose(got, _jax(mixed), **TOL)
    np.testing.assert_allclose(
        got, _jax(mixed, use_kernel=True, interpret=True), **TOL)


@pytest.mark.parametrize("name", sorted(MIXED_CASES))
def test_direct_read_bit_exact_vs_promote(name):
    """Direct int8 reads == dequantize the same blocks into the fp pool
    first, byte for byte (the port's plain version, as JAX's)."""
    mixed, promoted = _mixed(name)
    assert np.array_equal(_port(mixed), _port(promoted))


def test_fp_only_table_through_mixed_signature_bit_exact():
    rows, h, hkv, d, bs, tq = MIXED_CASES["mixed"]
    case = ragged_case(rows, h, hkv, d, bs, tq, pad_tiles=2)
    shape = (2,) + case["k_pool"].shape[1:]
    quant = dict(kq_pool=np.zeros(shape, np.int8),
                 vq_pool=np.zeros(shape, np.int8),
                 k_scales=np.ones(2, np.float32),
                 v_scales=np.ones(2, np.float32))
    assert np.array_equal(_port(dict(case, **quant)), _port(case))


def test_block_id_check_admits_int8_slots():
    mixed, _ = _mixed("mixed")
    _port(mixed, check_block_ids=True)              # ids in [-NQ, NB)
    nq = mixed["kq_pool"].shape[0]
    bad = dict(mixed, block_tables=mixed["block_tables"].copy())
    bad["block_tables"][0, 0] = -nq - 1
    with pytest.raises(ValueError, match="outside the pools"):
        _port(bad, check_block_ids=True)
    with pytest.raises(ValueError, match="go together"):
        paged.ragged_paged_attention(
            *[torch.from_numpy(mixed[k]) for k in RAGGED_ARGS],
            kq_pool=torch.from_numpy(mixed["kq_pool"]))


def test_cpu_tensors_never_count_a_launch():
    mixed, _ = _mixed("gqa")
    before = (paged.ragged_paged_attention.launches,
              paged.ragged_paged_attention.mixed_launches)
    _port(mixed)
    assert (paged.ragged_paged_attention.launches,
            paged.ragged_paged_attention.mixed_launches) == before


# -- cache-level: compression is a copy ------------------------------------

class TestCompressCold:
    def test_shared_blocks_compress_without_touching_refs(self):
        c = _cache(compress_blocks=8)
        toks = list(range(8))
        c.alloc_sequence(1, toks)
        c.commit_prefill(1, 8)
        c.alloc_sequence(2, toks)            # full hit: blocks shared
        assert c.shared_blocks == 2
        c.step_now = 10                       # both blocks long idle
        assert c.compress_cold() == 2
        assert [c.ref_count(b) for b in c.block_table(1)] == [2, 2]
        assert tuple(toks[:4]) in c._cindex and tuple(toks) in c._cindex
        n = c.alloc_sequence(3, toks)        # fp index untouched
        assert n == 7 and c.stats()["promote_total"] == 0
        assert len(c.drain_compress()) == 2
        for s in (1, 2, 3):
            c.free_sequence(s)
        c.assert_quiesced()

    def test_idle_gate_and_recompress_noop(self):
        c = _cache(compress_blocks=8)
        toks = list(range(8))
        c.alloc_sequence(1, toks)
        c.commit_prefill(1, 8)
        c.free_sequence(1)                    # cached-free at step 0
        c.step_now = 2
        assert c.compress_cold() == 0      # not idle yet
        c.step_now = 4
        assert c.compress_cold() == 2
        assert c.compress_cold() == 0      # already resident
        c.drain_compress()
        c.assert_quiesced()

    def test_quiesced_rejects_undrained_stages(self):
        c = _cache(compress_blocks=8)
        c.alloc_sequence(1, list(range(8)))
        c.commit_prefill(1, 8)
        c.free_sequence(1)
        c.step_now = 10
        c.compress_cold()
        with pytest.raises(RuntimeError):
            c.assert_quiesced()
        c.drain_compress()
        c.assert_quiesced()


def _direct_alloc_rig(c):
    toks = list(range(10))
    c.alloc_sequence(1, toks)
    c.commit_prefill(1, 10)
    c.free_sequence(1)
    c.step_now = 10
    assert c.compress_cold() == 2
    staged = [c.drain_compress()]
    # churn the fp copies out so the int8 copies are the only residents
    for s, base in ((2, 100), (3, 200), (4, 300), (5, 400)):
        c.alloc_sequence(s, [base + i for i in range(16)])
        c.commit_prefill(s, 16)
        c.free_sequence(s)
    assert tuple(toks[:4]) not in c._index
    n = c.alloc_sequence(9, toks)
    table = c.block_table(9)
    staged.append(c.drain_compress())      # lanes staged by churn evictions
    return n, table, staged


def test_cache_direct_alloc_pins_and_frees_slots():
    """Matched compressed blocks land in the table bias-encoded
    (-slot-1), pin their slots against spill, and unpin on free — with
    the same tables, slots and staged lanes as the JAX cache (fork
    pins wait for the n-best port)."""
    c = _cache(compress_blocks=8)
    n, table, staged = _direct_alloc_rig(c)
    assert n == 8                        # both full blocks served cached
    assert table[0] < 0 and table[1] < 0 and table[2] >= 0
    assert c.stats()["direct_int8_reads"] == 2
    assert c.stats()["promote_total"] == 0
    slots = {-b - 1 for b in table[:2]}
    assert all(c._cslot_refs[s] == 1 for s in slots)
    assert _direct_alloc_rig(_cache(JaxPagedKVCache, compress_blocks=8)) \
        == (n, table, staged)
    c.free_sequence(9)
    assert not c._cslot_refs
    c.assert_quiesced()


def test_copy_on_write_refuses_an_int8_entry():
    c = _cache(compress_blocks=8)
    _direct_alloc_rig(c)
    with pytest.raises(RuntimeError, match="int8-resident"):
        c.ensure_writable(9, 0, 1)


# -- engine-level: the same traffic through both engines -------------------

TAILS = [[21, 22, 23, 24], [31, 32, 33, 34], [41, 42, 43, 44]]


def _cold_churn_warm(prompt, filler=8, churn=16):
    def run(eng):
        out = [eng.generate([prompt], max_new_tokens=6)]
        out.append(eng.generate([[50] * filler], max_new_tokens=8))
        for i in range(3):                              # evict fp copies
            out.append(eng.generate([[30 + i] * churn], max_new_tokens=12))
        out.append(eng.generate([prompt], max_new_tokens=6))
        return out
    return run


def test_compress_promote_identity(models):
    """kv_promote_hits=1: the fp copies are evicted, the int8 copies
    survive, and the promoted prefix reproduces the cold output."""
    prompt = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8]
    eng, out = _same_run(models, _cold_churn_warm(prompt),
                         kv_compress_blocks=24, kv_promote_hits=1)
    assert out[-1] == out[0]
    st = eng.cache.stats()
    assert st["promote_total"] >= 3 and st["compress_total"] > 0
    assert st["compress_hit_tokens"] > 0
    assert eng.obs.get("ptpu_kv_promote_total").value == st["promote_total"]


def test_direct_read_serves_in_place(models):
    """kv_promote_hits=0: hits on compressed-only blocks are read in
    place — no fp claim, no promote lanes."""
    prompt = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8, 6, 2]
    eng, out = _same_run(models, _cold_churn_warm(prompt),
                         kv_compress_blocks=24)
    assert out[-1] == out[0]
    st = eng.cache.stats()
    bs = eng.cache.block_size
    assert st["promote_total"] == 0
    assert st["direct_int8_reads"] == 3                # 3 full blocks hit
    assert st["direct_int8_tokens"] == 3 * bs
    assert eng.obs.get("ptpu_kv_direct_int8_reads_total").value == 3
    assert eng.obs.get("ptpu_kv_direct_int8_tokens_total").value == 3 * bs
    assert eng.obs.get("ptpu_kv_compressed_blocks").value == \
        st["compressed_blocks"]
    assert eng.kv_direct_int8


def test_direct_read_output_matches_promote_path(models):
    """Identical traffic through a direct-read engine and an
    always-promote engine gives identical outputs."""
    prompt = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8, 6, 2]
    outs = []
    for hits in (0, 1):
        eng, out = _same_run(models, _cold_churn_warm(prompt),
                             kv_compress_blocks=24, kv_promote_hits=hits)
        st = eng.cache.stats()
        assert (st["promote_total"] == 0) == (hits == 0)
        assert (st["direct_int8_reads"] > 0) == (hits == 0)
        outs.append(out)
    assert outs[0] == outs[1]


def test_full_prompt_hit_promotes_final_block(models):
    prompt = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8]    # 3 exact blocks
    eng, out = _same_run(models, _cold_churn_warm(prompt),
                         kv_compress_blocks=24)
    assert out[-1] == out[0]
    st = eng.cache.stats()
    assert st["promote_total"] == 1 and st["direct_int8_reads"] == 2


def test_precision_churn_keeps_one_step_shape(models):
    """kv_promote_hits=2: the first re-request reads int8 in place, the
    second promotes back to fp, the third reads fp — every rung gives
    the cold output on one step shape."""
    prompt = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8, 6, 2]

    def run(eng):
        def churn():
            eng.generate([[50] * 9], max_new_tokens=8)
            for i in range(3):
                eng.generate([[30 + i] * 15], max_new_tokens=12)
        out = [eng.generate([prompt], max_new_tokens=6)]
        churn()
        out.append(eng.generate([prompt], max_new_tokens=6))
        out.append((eng.cache.direct_reads, eng.cache.promoted_total))
        churn()
        out.append(eng.generate([prompt], max_new_tokens=6))
        out.append(eng.cache.promoted_total)
        out.append(eng.generate([prompt], max_new_tokens=6))
        return out
    _, out = _same_run(models, run, kv_compress_blocks=24,
                       kv_promote_hits=2)
    assert out[1] == out[3] == out[5] == out[0]
    assert out[2] == (3, 0) and out[4] == 3


def test_preempt_compress_revive_completes(models):
    """A tight pool preempts; the victims' committed blocks demote into
    the int8 tier and every request completes at full length."""
    prompts = [[7, 3, 7, 3] + t for t in TAILS]
    jm, jvars, tm = models
    want = ServeEngine(tm, device="cpu", registry=MetricsRegistry(),
                       **_kw(max_batch_size=3, num_blocks=64)).generate(
        prompts, max_new_tokens=12)
    eng, got = _same_run(
        models, lambda e: e.generate(prompts, max_new_tokens=12),
        max_batch_size=3, num_blocks=9, kv_compress_blocks=16)
    assert [len(g) for g in got] == [len(w) for w in want]
    assert sum(r.preemptions for r in eng.finished.values()) > 0
    assert eng.cache.stats()["compress_total"] > 0


def test_budget_zero_is_bit_identical_to_seed(models):
    prompts = [[7, 3, 7, 3] + t for t in TAILS]
    jm, jvars, tm = models
    a = ServeEngine(tm, device="cpu", registry=MetricsRegistry(),
                    **_kw(max_batch_size=3, num_blocks=9))
    b = ServeEngine(tm, device="cpu", registry=MetricsRegistry(),
                    **_kw(max_batch_size=3, num_blocks=9,
                          kv_compress_blocks=0))
    assert b.cache.compress_enabled is False and b.cache.qpools == []
    assert a.generate(prompts, max_new_tokens=12) == \
        b.generate(prompts, max_new_tokens=12)
    assert a.cache.stats() == b.cache.stats()
    assert "compress_total" not in b.cache.stats()
    assert len(b.step_shapes) == 1
    b.cache.assert_quiesced()


def test_engine_advertises_direct_capability(models):
    jm, jvars, tm = models

    def direct(**kw):
        return ServeEngine(tm, device="cpu", registry=MetricsRegistry(),
                           **_kw(**kw)).kv_direct_int8
    assert direct(kv_compress_blocks=24) is True
    assert direct(kv_compress_blocks=24, kv_promote_hits=2) is True
    assert direct(kv_compress_blocks=24, kv_promote_hits=1) is False
    assert direct() is False


def test_effective_pool_bytes_count_int8_only_content(models):
    """The gauge counts compressed entries whose fp copy is gone at the
    fp bytes they stand in for, as the JAX cache does."""
    prompt = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8, 6, 2]
    port, ref = _engines(models, kv_compress_blocks=24)
    for eng in (port, ref):
        _cold_churn_warm(prompt)(eng)
    assert port.cache.effective_pool_bytes() == \
        ref.cache.effective_pool_bytes()
    assert port.obs.get("ptpu_kv_pool_effective_bytes").value == \
        port.cache.effective_pool_bytes()
