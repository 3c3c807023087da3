"""The port's host KV tier (engine/kvtier.py and its rungs in the cache,
scheduler and engine) against the JAX package's.

Mirrors tests/test_kvtier.py (its router test runs against the port's
router), the host-tier case of tests/test_prefix_cache.py and those of
tests/test_kvcompress.py (the device-int8 fast path, the host-load dst
the cold sweep skips, the compressed pool spilling to the host):

- the tier: LRU under a byte budget, fp round trips bit for bit, int8
  within one quantization step with JAX's very blobs, bf16 kept as its
  raw 2-byte payload, the directory helpers and metric series as JAX's;
- spills: a float32 or int8 spill written by either package loads in the
  other with equal entries; a bf16 fp spill loads in JAX as `|V2` blobs
  that `jnp.asarray` refuses, which is JAX's own behaviour (pinned);
- the cache: demotion copies out without touching refcounts, a request
  cancelled before its revival flushes leaves the tier copy revivable,
  and a scripted walk gives JAX's tables and staged loads;
- the engine: preempt -> demote -> revive equals the roomy run and the
  JAX engine's streams and tier counters; revivals wider than one lane
  batch; the int8 tier; finish demotion; a warm start from either
  package's spill.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.engine import HostKVTier as JaxHostKVTier
from paddle_tpu.engine import PagedKVCache as JaxPagedKVCache
from paddle_tpu.engine import ServeEngine as JaxServeEngine
from paddle_tpu.engine.kvtier import prefix_digest as jax_prefix_digest
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.engine import (HostKVTier, PagedKVCache, ServeEngine,
                                     prefix_digest)
from paddle_tpu_torch.engine.kvtier import to_host, to_torch
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.quant.int8_compute import QMAX, quantize_host_int8
from paddle_tpu_torch.serve import router as router_mod
from paddle_tpu_torch.serve.router import Router

VOCAB = 61
TAILS = [[21, 22, 23, 24], [31, 32, 33, 34], [41, 42, 43, 44]]
SYSTEM = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8]
TIER_COUNTERS = ("tier_revivals", "tier_hit_tokens", "cached_free_evictions",
                 "compress_spills")


@pytest.fixture(scope="module")
def models():
    """tests/test_kvtier.py's fixture model, its JAX init weights loaded
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
    kw.setdefault("num_blocks", 64)
    return kw


def _engine(models, **kw):
    return ServeEngine(models[2], device="cpu", registry=MetricsRegistry(),
                       **_kw(**kw))


def _jax_engine(models, **kw):
    return JaxServeEngine(models[0], models[1], registry=JaxRegistry(),
                          **_kw(**kw))


def _same_as_jax(models, scenario, **kw):
    """`scenario(engine)` on both packages' engines: equal outputs, tier
    counters and stats keys; one step shape; both quiesce."""
    port, ref = _engine(models, **kw), _jax_engine(models, **kw)
    got, want = scenario(port), scenario(ref)
    assert got == want
    ps, js = port.cache.stats(), ref.cache.stats()
    assert ps == js
    for name in TIER_COUNTERS:
        assert getattr(port.cache, name) == getattr(ref.cache, name), name
    assert port.step_graph.compiles == 1 and len(port.step_shapes) == 1
    assert ref._step_fn._cache_size() == 1
    port.cache.assert_quiesced()
    ref.cache.assert_quiesced()
    return port, got


def _tier(cls=HostKVTier, budget=1 << 20, **kw):
    kw.setdefault("registry",
                  MetricsRegistry() if cls is HostKVTier else JaxRegistry())
    return cls(budget, **kw)


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


def _layers(rng, num_layers=1, bs=4, heads=2, hd=8):
    """One block's per-layer (k, v) payload: 512 bytes per layer."""
    return [(rng.standard_normal((bs, heads, hd)).astype(np.float32),
             rng.standard_normal((bs, heads, hd)).astype(np.float32))
            for _ in range(num_layers)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.kind == "V" else a


def _entries(tier):
    """Every resident entry in LRU order: (key, nbytes, blob arrays as
    raw bytes, scales and dtype names as python values)."""
    out = []
    for key, ent in tier._entries.items():
        blobs = [tuple(_bits(p).tobytes() if isinstance(p, np.ndarray)
                       else str(np.dtype(p)) if not isinstance(p, float)
                       else p for p in blob) for blob in ent.blobs]
        out.append((key, ent.nbytes, blobs))
    return out


# -- the tier --------------------------------------------------------------

class TestHostKVTier:
    def test_lru_byte_budget_evicts_coldest(self):
        rng = np.random.default_rng(0)
        tier = _tier(budget=1024)            # room for exactly 2 entries
        tier.put((1,), _layers(rng))
        tier.put((2,), _layers(rng))
        assert len(tier) == 2 and tier.nbytes == 1024
        tier.get((1,))                       # LRU touch: (2,) is coldest
        tier.put((3,), _layers(rng))
        assert tier.contains((1,)) and tier.contains((3,))
        assert not tier.contains((2,))
        assert len(tier) == 2 and tier.nbytes <= 1024

    def test_oversized_block_is_refused(self):
        rng = np.random.default_rng(1)
        tier = _tier(budget=100)             # one block needs 512 bytes
        assert tier.put((1,), _layers(rng)) is False
        assert len(tier) == 0 and tier.nbytes == 0
        with pytest.raises(ValueError):
            _tier(budget=0)

    def test_fp_roundtrip_bit_exact(self):
        rng = np.random.default_rng(2)
        tier = _tier()
        layers = _layers(rng, num_layers=2)
        tier.put((7, 8, 9), layers)
        back = tier.get((7, 8, 9))
        assert back is not None and len(back) == 2
        for (k0, v0), (k1, v1) in zip(layers, back):
            assert np.array_equal(k0, k1) and k1.dtype == k0.dtype
            assert np.array_equal(v0, v1) and v1.dtype == v0.dtype
        assert tier.get((7, 8)) is None

    def test_int8_roundtrip_within_one_quant_step(self):
        rng = np.random.default_rng(3)
        tier = _tier(int8=True)
        layers = _layers(rng, num_layers=2)
        tier.put((7, 8, 9), layers)
        back = tier.get((7, 8, 9))
        for (k0, v0), (k1, v1) in zip(layers, back):
            for orig, deq in ((k0, k1), (v0, v1)):
                assert deq.dtype == orig.dtype
                bound = np.max(np.abs(orig)) / 127 + 1e-7
                assert np.max(np.abs(deq - orig)) <= bound
        fp = _tier()
        fp.put((7, 8, 9), layers)
        assert tier.nbytes < 0.6 * fp.nbytes

    @pytest.mark.parametrize("int8", [False, True])
    def test_blobs_and_revivals_equal_jax(self, int8):
        """The same payloads put into both packages' tiers: the same
        stored blobs (int8 payload, scales, dtype names), byte counts
        and revived arrays, bit for bit."""
        rng = np.random.default_rng(4)
        port, ref = _tier(int8=int8), _tier(JaxHostKVTier, int8=int8)
        for key in ((1, 2), (3, 4), (5, 6)):
            layers = _layers(rng, num_layers=2)
            assert port.put(key, layers) and ref.put(key, layers)
        assert _entries(port) == _entries(ref)
        for key in ((3, 4), (1, 2)):
            for (pk, pv), (jk, jv) in zip(port.get(key), ref.get(key)):
                assert pk.dtype == jk.dtype
                assert np.array_equal(pk, jk) and np.array_equal(pv, jv)
        assert list(port._entries) == list(ref._entries)

    def test_bf16_payloads_stay_raw(self):
        """A bf16 block is held as its raw `|V2` payload: to_host and
        to_torch round-trip its bits; the int8 tier quantizes its float
        values and revives bf16 bits equal to JAX's ml_dtypes cast."""
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.standard_normal((2, 4, 2, 8))
                             .astype(np.float32)).to(torch.bfloat16)
        k, v = to_host(x[0]), to_host(x[1])
        assert k.dtype.str == "|V2" and k.nbytes == x[0].numel() * 2
        assert torch.equal(to_torch(k), x[0])
        fp, q8 = _tier(), _tier(int8=True)
        for tier in (fp, q8):
            tier.put((1,), [(k, v)])
        assert torch.equal(to_torch(fp.get((1,))[0][1]), x[1])
        ref = _tier(JaxHostKVTier, int8=True)
        ref.put((1,), [(jnp.asarray(x[0].float().numpy(), jnp.bfloat16),
                        jnp.asarray(x[1].float().numpy(), jnp.bfloat16))])
        got, want = q8.get((1,))[0], ref.get((1,))[0]
        for g, w in zip(got, want):
            assert g.dtype.str == "|V2" and w.dtype.name == "bfloat16"
            assert np.array_equal(g.view(np.int16), w.view(np.int16))

    def test_host_fast_path_is_one_quant_step(self):
        """put_device_int8: an int8 tier stores the device q/s verbatim,
        an fp tier their exact dequantization; either way the round trip
        is within scale / 127, and both equal JAX's tiers."""
        rng = np.random.default_rng(2)
        fp = _layers(rng, num_layers=2)
        qlayers = []
        for k, v in fp:
            kq, ks = quantize_host_int8(k)
            vq, vs = quantize_host_int8(v)
            qlayers.append((kq, ks, vq, vs))
        for int8 in (True, False):
            tier = _tier(int8=int8)
            ref = _tier(JaxHostKVTier, int8=int8)
            assert tier.put_device_int8((1, 2, 3), qlayers, torch.float32)
            assert ref.put_device_int8((1, 2, 3), qlayers, np.float32)
            assert _entries(tier) == _entries(ref)
            back = tier.get((1, 2, 3))
            for (k0, v0), (k1, v1), (kq, ks, vq, vs) in zip(fp, back,
                                                            qlayers):
                assert k1.dtype == np.float32
                assert np.max(np.abs(k1 - k0)) <= ks / QMAX + 1e-7
                assert np.max(np.abs(v1 - v0)) <= vs / QMAX + 1e-7
            if int8:
                kq0, ks0, _, _, _ = tier._entries[(1, 2, 3)].blobs[0]
                assert np.array_equal(kq0, qlayers[0][0])
                assert ks0 == qlayers[0][1]

    def test_metric_series_equal_jax(self):
        """The same operations on both tiers move the same series: puts,
        a re-put of a resident key, LRU evictions, the fast path, a
        revival note, a spill and a warm start."""
        rng = np.random.default_rng(6)
        regs = (MetricsRegistry(), JaxRegistry())
        tiers = (HostKVTier(1536, registry=regs[0]),
                 JaxHostKVTier(1536, registry=regs[1]))
        payloads = [_layers(rng) for _ in range(4)]
        q = [quantize_host_int8(a) for a in payloads[0][0]]
        qlayers = [(q[0][0], q[0][1], q[1][0], q[1][1])]
        for tier in tiers:
            for i, layers in enumerate(payloads):
                tier.put((i,), layers, reason="preempt" if i else "evict")
            tier.put((3,), payloads[3])              # resident: a touch
            tier.put_device_int8((9,), qlayers, "float32")
            tier.note_revived(2, 8)
        names = ("ptpu_kv_tier_revived_blocks_total",
                 "ptpu_kv_tier_revived_tokens_total",
                 "ptpu_kv_tier_lru_evictions_total", "ptpu_kv_tier_bytes",
                 "ptpu_kv_tier_entries")
        for name in names:
            assert regs[0].get(name).value == regs[1].get(name).value, name
        for reason in ("evict", "preempt"):
            assert (regs[0].get("ptpu_kv_tier_demoted_blocks_total")
                    .labels(reason=reason).value
                    == regs[1].get("ptpu_kv_tier_demoted_blocks_total")
                    .labels(reason=reason).value)
        assert tiers[0].stats() == tiers[1].stats()

    def test_directory_helpers_equal_jax(self):
        rng = np.random.default_rng(7)
        port, ref = _tier(int8=True), _tier(JaxHostKVTier, int8=True)
        keys = [tuple(rng.integers(0, 2 ** 31, n).tolist())
                for n in (4, 8, 12)]
        for key in keys:
            layers = _layers(rng)
            port.put(key, layers)
            ref.put(key, layers)
        assert port.advertised() == ref.advertised()
        assert port.advertised(limit=2) == ref.advertised(limit=2)
        got = port.entry_by_digest(prefix_digest(keys[1]))
        want = ref.entry_by_digest(jax_prefix_digest(keys[1]))
        assert got[0] == want[0] == keys[1] and got[2] == want[2]
        assert port.entry_by_digest("ffffffff") is None
        # a lookup does not touch the LRU order
        assert list(port._entries) == keys == list(ref._entries)
        # an entry pulled from JAX's tier revives identically here
        other = _tier(int8=True)
        assert other.insert_encoded(*want)
        for (pk, pv), (jk, jv) in zip(other.get(keys[1]),
                                      ref.get(keys[1])):
            assert np.array_equal(pk, jk) and np.array_equal(pv, jv)


def test_prefix_digest_equals_jax():
    """Replica advertisements and lookups hash the same way in both
    packages, for ids past int32 and for the empty prefix."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        toks = rng.integers(-2 ** 33, 2 ** 33, rng.integers(1, 40)).tolist()
        assert prefix_digest(toks) == jax_prefix_digest(toks)
    assert prefix_digest([]) == jax_prefix_digest([]) == "00000000"


# -- spills ----------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spill_loads_in_the_other_package(tmp_path, writer, int8):
    """A float32 spill (fp or int8 mode) written by one package warm-
    starts the other's tier with equal entries in equal LRU order."""
    rng = np.random.default_rng(8)
    classes = (HostKVTier, JaxHostKVTier)
    src_cls, dst_cls = classes if writer == "port" else classes[::-1]
    src = _tier(src_cls, int8=int8)
    for n in (4, 8, 12, 16):
        src.put(tuple(range(n)), _layers(rng, num_layers=2))
    src.get((0, 1, 2, 3))                        # reorder the LRU
    assert src.spill(str(tmp_path)) == 4
    dst = _tier(dst_cls, int8=int8)
    assert dst.load_spill(str(tmp_path)) == 4
    assert _entries(dst) == _entries(src)
    for key in list(src._entries):
        for (a, b), (c, d) in zip(src.get(key), dst.get(key)):
            assert np.array_equal(a, c) and np.array_equal(b, d)
    # a tier of the other mode starts cold
    assert _tier(dst_cls, int8=not int8).load_spill(str(tmp_path)) == 0


def test_bf16_spills_are_pinned(tmp_path):
    """bf16 in npz files: the port writes a bf16 fp spill as raw `|V2`,
    as `np.savez` writes JAX's ml_dtypes arrays. JAX loads such a spill
    (its own included) as `|V2` blobs that `jnp.asarray` refuses, so its
    revival fails (JAX's behaviour, pinned); the port loads either
    package's bf16 spill bit for bit. In int8 mode a bf16 spill records
    the dtype name and loads in both packages to the same bf16 bits."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 4, 2, 8))
                         .astype(np.float32)).to(torch.bfloat16)
    raw = [(to_host(x[0]), to_host(x[1]))]
    typed = [(np.asarray(jnp.asarray(x[0].float().numpy(), jnp.bfloat16)),
              np.asarray(jnp.asarray(x[1].float().numpy(), jnp.bfloat16)))]
    for int8 in (False, True):
        port_dir = tmp_path / f"port{int8}"
        jax_dir = tmp_path / f"jax{int8}"
        port, ref = _tier(int8=int8), _tier(JaxHostKVTier, int8=int8)
        port.put((1, 2, 3, 4), raw)
        ref.put((1, 2, 3, 4), typed)
        port.spill(str(port_dir))
        ref.spill(str(jax_dir))
        in_jax = _tier(JaxHostKVTier, int8=int8)
        assert in_jax.load_spill(str(port_dir)) == 1
        k = in_jax.get((1, 2, 3, 4))[0][0]
        in_port = _tier(int8=int8)
        assert in_port.load_spill(str(jax_dir)) == 1
        back = in_port.get((1, 2, 3, 4))[0][0]
        assert back.dtype.str == "|V2"
        assert np.array_equal(back.view(np.int16),
                              port.get((1, 2, 3, 4))[0][0].view(np.int16))
        if int8:
            assert k.dtype.name == "bfloat16"
            assert np.array_equal(k.view(np.int16), back.view(np.int16))
        else:
            assert k.dtype.str == "|V2"
            assert np.array_equal(k.view(np.int16), raw[0][0].view(np.int16))
            with pytest.raises(TypeError):
                jnp.asarray(k)


def test_load_spill_tolerates_missing_torn_and_foreign(tmp_path):
    rng = np.random.default_rng(10)
    assert _tier().load_spill(str(tmp_path / "none")) == 0
    src = _tier()
    src.put((1, 2, 3, 4), _layers(rng))
    src.spill(str(tmp_path))
    with open(tmp_path / "tier-spill.npz", "ab") as f:
        f.write(b"torn")
    assert _tier().load_spill(str(tmp_path)) == 0


# -- cache-level demotion / revival bookkeeping ----------------------------

class TestCacheTierWalk:
    def test_demote_live_shared_sequence_leaves_refs_intact(self):
        tier = _tier()
        c = _cache(host_tier=tier)
        toks = list(range(8))
        c.alloc_sequence(1, toks)
        c.commit_prefill(1, 8)
        c.alloc_sequence(2, toks)            # full hit: blocks shared
        assert c.shared_blocks == 2
        assert c.demote_sequence(1) == 2     # preempt-path copy-out
        assert tier.contains(tuple(toks[:4])) and tier.contains(tuple(toks))
        assert [c.ref_count(b) for b in c.block_table(1)] == [2, 2]
        assert c.demote_sequence(2) == 0     # the tier holds both keys
        c.free_sequence(1)
        c.free_sequence(2)
        c.assert_quiesced()

    def test_cancel_mid_revival_keeps_tier_copy_revivable(self):
        tier = _tier()
        c = _cache(host_tier=tier)
        toks = list(range(8))
        c.alloc_sequence(1, toks)
        c.commit_prefill(1, 8)
        c.demote_sequence(1)
        c.free_sequence(1)
        c.alloc_sequence(2, [90 + i for i in range(60)])  # recycle all
        c.free_sequence(2)
        c.alloc_sequence(3, toks)
        assert c.tier_revivals == 2
        assert len(c._pending_host_loads) == 2
        c.free_sequence(3)                   # dies before the flush
        c.assert_quiesced()                  # pending loads cancelled
        assert c.alloc_sequence(4, toks) == 7
        assert c.tier_revivals == 4
        loads = c.drain_host_loads()
        assert sorted(b for b, _ in loads) == sorted(c.block_table(4))
        c.free_sequence(4)
        c.assert_quiesced()

    def test_stats_carry_tier_series(self):
        c = _cache(host_tier=_tier())
        toks = list(range(8))
        c.alloc_sequence(1, toks)
        c.commit_prefill(1, 8)
        c.demote_sequence(1)
        c.free_sequence(1)
        s = c.stats()
        assert s["tier_entries"] == 2 and s["tier_bytes"] > 0
        assert s["tier_int8"] is False and s["tier_revivals"] == 0
        assert "tier_entries" not in _cache().stats()

    def test_host_load_dst_not_compressed_same_step(self):
        """A revival's dst block holds stale bytes until the engine
        writes its load, which runs AFTER the quantize lanes: the cold
        sweep must skip it (and it is stamped hot at admission)."""
        tier = _tier()
        c = _cache(compress_blocks=8, host_tier=tier)
        rng = np.random.default_rng(3)
        toks = list(range(8))
        for end in (4, 8):
            assert tier.put(tuple(toks[:end]), _layers(rng),
                            reason="preempt")
        c.step_now = 50
        assert c.alloc_sequence(1, toks) == 7
        assert len(c._pending_host_loads) == 2
        assert c.compress_cold() == 0
        assert c.drain_compress() == []
        for b, _ in c._pending_host_loads:
            assert c._last_hit[b] == 50
        c.drain_host_loads()
        c.free_sequence(1)
        c.assert_quiesced()

    def test_tier_walk_equals_jax(self):
        """The same script on both caches, each over its own tier holding
        the same payloads: the same cached counts, tables, staged loads
        (blocks and payload bits), demotions and tier revivals."""
        rng = np.random.default_rng(11)
        pay = {n: _layers(rng) for n in (4, 8, 12)}

        def run(cache_cls, tier_cls):
            tier = _tier(tier_cls)
            c = _cache(cache_cls, host_tier=tier, num_blocks=10)
            toks = list(range(14))
            for n in (4, 8):
                tier.put(tuple(toks[:n]), pay[n])
            out = [c.alloc_sequence(1, toks), c.block_table(1)]
            loads = c.drain_host_loads()
            out.append([(b, [(k.tobytes(), v.tobytes()) for k, v in la])
                        for b, la in loads])
            c.commit_prefill(1, 14)
            c.alloc_sequence(2, [50] * 20)
            c.commit_prefill(2, 20)
            out += [c.demote_sequence(2), len(tier), c.stats()]
            c.free_sequence(1)
            c.free_sequence(2)
            c.alloc_sequence(3, [60] * 30)   # recycles cached-free blocks
            out += [len(tier), c.cached_free_evictions, c.stats()]
            c.free_sequence(3)
            c.assert_quiesced()
            return out

        assert (run(PagedKVCache, HostKVTier)
                == run(JaxPagedKVCache, JaxHostKVTier))


# -- engine-level: preempt -> demote -> revive is invisible ----------------

def test_preempt_demote_revive_identical_to_roomy(models):
    """A tight pool preempts; with a host tier the victim's committed
    blocks demote and re-admission revives them. The streams equal the
    roomy run, and JAX's engine's, with its tier counters."""
    prompts = [[7, 3, 7, 3] + t for t in TAILS]
    want = _engine(models, max_batch_size=3).generate(prompts,
                                                      max_new_tokens=12)
    tight, got = _same_as_jax(
        models, lambda e: e.generate(prompts, max_new_tokens=12),
        max_batch_size=3, num_blocks=9, host_tier_bytes=1 << 20)
    assert got == want
    assert sum(r.preemptions for r in tight.finished.values()) > 0
    demoted = tight.obs.get("ptpu_kv_tier_demoted_blocks_total")
    assert demoted.labels(reason="preempt").value > 0


def _cold_churn_warm(prompt, churn, n_new=6):
    def run(eng):
        cold = eng.generate([prompt], max_new_tokens=n_new)
        for wave in churn:
            eng.generate(wave, max_new_tokens=4)
        before = eng.prefill_tokens_computed
        warm = eng.generate([prompt], max_new_tokens=n_new)
        return cold, warm, eng.prefill_tokens_computed - before
    return run


def test_host_tier_revival_identical_and_saves_prefill(models):
    """cold -> churn (cached-free blocks demote to the tier) -> warm:
    the warm run revives the prompt's KV instead of re-prefilling it,
    gives exactly the cold tokens, and computes less prefill."""
    prompt = SYSTEM + TAILS[0]                   # 16 tokens, 4 full blocks
    eng, (cold, warm, computed) = _same_as_jax(
        models, _cold_churn_warm(prompt, [[[50 + i] * 16] for i in range(2)]),
        num_blocks=10, host_tier_bytes=1 << 20)
    assert warm == cold
    assert eng.cache.stats()["tier_revivals"] >= 3
    assert computed < len(prompt)


def test_revival_wider_than_one_lane_batch(models):
    """A 44-token prompt revives eleven blocks: two batches of the eight
    revival lanes, the same tokens as the cold run and JAX's, and only
    the capped last token is computed."""
    prompt = list(range(1, 45))
    eng, (cold, warm, computed) = _same_as_jax(
        models, _cold_churn_warm(prompt, [[[50 + i] * 44] for i in range(2)]),
        num_blocks=16, host_tier_bytes=1 << 20, max_prefill_tokens=64)
    assert warm == cold
    assert eng.cache.stats()["tier_revivals"] == 11
    assert computed == 1


def test_int8_tier_revives_and_completes(models):
    """cold -> churn -> warm on an int8 tier: the warm run revives
    quantized KV and completes; the streams and revivals equal JAX's
    (both quantize with the same host codec)."""
    prompt = SYSTEM + TAILS[0]
    eng, (cold, warm, _) = _same_as_jax(
        models, _cold_churn_warm(prompt, [[[50 + i] * 16] for i in range(2)]),
        num_blocks=10, host_tier_bytes=1 << 20, kv_tier_int8=True)
    assert len(warm[0]) == len(cold[0]) > 0
    assert eng.obs.get("ptpu_kv_tier_revived_blocks_total").value > 0


def test_compressed_pool_spills_to_host_tier(models):
    """device fp -> device int8 -> host: churn past the compressed
    pool's capacity lands the coldest entries in the host tier, as in
    JAX's engine."""
    def run(eng):
        out = eng.generate([[7, 3, 7, 3] + t for t in TAILS],
                           max_new_tokens=8)
        for i in range(4):
            out += eng.generate([[30 + i] * 16], max_new_tokens=12)
        return out
    eng, _ = _same_as_jax(models, run, num_blocks=16, kv_compress_blocks=4,
                          host_tier_bytes=1 << 20, kv_tier_int8=True)
    assert eng.cache.stats()["compress_spills"] > 0
    assert eng.host_tier.stats()["tier_entries"] > 0


def test_demote_finished_feeds_the_tier(models):
    """demote_finished: every finished request's committed blocks land
    in the host tier under reason="finish", with JAX's keys, including
    int8 direct-read blocks shipped down the fast path."""
    prefix = SYSTEM + [6, 2, 9, 9]

    def run(eng):
        out = eng.generate([prefix + [1]], max_new_tokens=4)
        for i in range(4):
            out += eng.generate([[30 + i] * 16], max_new_tokens=6)
        out += eng.generate([prefix + [5, 5]], max_new_tokens=4)
        return out, list(eng.host_tier._entries)
    eng, (_, keys) = _same_as_jax(models, run, num_blocks=16,
                                  kv_compress_blocks=24, demote_finished=True,
                                  host_tier_bytes=1 << 20)
    assert tuple(prefix[:4]) in keys
    assert eng.cache.stats()["direct_int8_reads"] > 0
    finish = eng.obs.get("ptpu_kv_tier_demoted_blocks_total")
    assert finish.labels(reason="finish").value > 0


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_warm_start_from_either_packages_spill(models, tmp_path, writer,
                                               int8):
    """An engine of one package serves and spills its tier; an engine of
    the other starts from that spill (tier_spill_dir), revives the
    prompt without re-prefilling it, and streams the writer's tokens."""
    prompt = SYSTEM + TAILS[1]
    make = {"port": _engine, "jax": _jax_engine}
    src = make[writer](models, num_blocks=10, host_tier_bytes=1 << 20,
                       kv_tier_int8=int8, demote_finished=True)
    want = src.generate([prompt], max_new_tokens=6)
    assert src.host_tier.spill(str(tmp_path)) > 0
    dst = make["jax" if writer == "port" else "port"](
        models, num_blocks=10, host_tier_bytes=1 << 20, kv_tier_int8=int8,
        tier_spill_dir=str(tmp_path))
    assert len(dst.host_tier) == len(src.host_tier)
    assert dst.generate([prompt], max_new_tokens=6) == want
    assert dst.cache.stats()["tier_revivals"] == len(prompt) // 4
    assert dst.prefill_tokens_computed == 1


def test_reset_stats_republishes_boot_state(models, tmp_path):
    src = _engine(models, host_tier_bytes=1 << 20, demote_finished=True)
    src.generate([SYSTEM], max_new_tokens=3)
    n = src.host_tier.spill(str(tmp_path))
    eng = _engine(models, host_tier_bytes=1 << 20,
                  tier_spill_dir=str(tmp_path))
    loaded = eng.obs.get("ptpu_kv_tier_spill_loaded_blocks_total")
    assert loaded.value == n > 0
    eng.generate([[5, 9, 2]], max_new_tokens=2)
    eng.reset_stats()
    assert loaded.value == n
    assert eng.obs.get("ptpu_kv_tier_entries").value == len(eng.host_tier)
    assert eng.steps == 0


# -- fleet prefix directory (test_kvtier.py:230-270) ----------------------

def test_prefix_digest_matches_router_side():
    """The replica advertises kvtier.prefix_digest; the router looks up
    router.prefix_digest: the same function in the port, and JAX's."""
    rng = np.random.default_rng(5)
    for _ in range(5):
        toks = rng.integers(0, 2 ** 31, rng.integers(1, 40)).tolist()
        assert prefix_digest(toks) == router_mod.prefix_digest(toks) \
            == jax_prefix_digest(toks)
    assert prefix_digest([]) == "00000000"   # crc32(b"") pin


def test_router_prefers_longest_then_hottest():
    urls = [f"http://127.0.0.1:{9000 + i}" for i in range(3)]
    router = Router(urls, enable_directory=True)
    a, b, _ = router.replicas
    for r in router.replicas:
        r.ready = True
    prompt = list(range(12))
    primary = router.replicas[router_mod.prefix_shard(prompt, 3)]
    d4 = prefix_digest(prompt[:4])
    d8 = prefix_digest(prompt[:8])
    # longest match wins regardless of tier ...
    a.prefixes = {(4, d4): "device"}
    b.prefixes = {(8, d8): "host"}
    assert router.plan_route(prompt)[0] is b
    # ... and equal lengths split on tier heat (device beats host)
    a.prefixes = {(8, d8): "device"}
    assert router.plan_route(prompt)[0] is a
    # a prefix LONGER than the prompt never matches; with no match the
    # sticky hash primary leads
    a.prefixes = {(16, prefix_digest(list(range(16)))): "device"}
    b.prefixes = {}
    assert router.plan_route(prompt)[0] is primary
    # directory disabled ignores a perfect advertisement
    router.enable_directory = False
    b.prefixes = {(8, d8): "device"}
    assert router.plan_route(prompt)[0] is primary
