"""The port's fleet KV transfer (serve/kvxfer.py + wiring): a mirror of
tests/test_kvxfer.py over the port's engine, on the JAX test's
model.init weights.

- THE WIRE IS FAITHFUL: a tier entry round-tripped through the kvxfer
  envelope is blob-exact, and every corruption raises KVXferError.
- PULL -> REVIVE IS INVISIBLE: a decode engine that pulled its warm
  prefix from a prefill replica's /kvblocks streams byte-identically to
  a locally-warm run, reviving blocks, on its one step program.
- NEVER A WRONG ANSWER: a dead source or a corrupted blob counts a
  fallback, leaves the tier untouched, and the request re-prefills.
- THE ROUTER SPECIALIZES SAFELY: phase classification and kv_transfer
  hints.
- THE FRONT DOOR SPEAKS TEXT: the byte tokenizer, /v1/tokenize, and
  string prompts.
"""

import json
from http.client import HTTPConnection

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu_torch.engine import HostKVTier, ServeEngine
from paddle_tpu_torch.engine.kvtier import prefix_digest
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serve import kvxfer
from paddle_tpu_torch.serve.frontend import ServeFrontend
from paddle_tpu_torch.serve.router import Router
from paddle_tpu_torch.serve.sse import collect_stream, http_get
from paddle_tpu_torch.serve.tokenizer import ByteTokenizer

pytestmark = pytest.mark.kvxfer

VOCAB = 61


def _model(max_len=64):
    """The JAX test's fixture model: its `model.init(PRNGKey(0))` weights
    loaded into the port's CausalLM. The port's engine owns the model's
    weights, so `variables` is None."""
    jm = JaxCausalLM(vocab=VOCAB, model_dim=16, num_heads=4, num_layers=2,
                     ffn_dim=32, dropout=0.0, max_len=max_len)
    jvars = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    model = CausalLM(VOCAB, model_dim=16, num_heads=4, num_layers=2,
                     ffn_dim=32, dropout=0.0, max_len=max_len, device="cpu")
    load_jax_params(model, jax.device_get(jvars))
    return model, None


@pytest.fixture(scope="module")
def model_and_vars():
    return _model()


def _engine(model, variables, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("registry", MetricsRegistry())
    return ServeEngine(model, device="cpu", **kw)


def _tier(budget=1 << 20, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return HostKVTier(budget, **kw)


def _layers(rng, num_layers=2, bs=4, heads=2, hd=8):
    return [(rng.standard_normal((bs, heads, hd)).astype(np.float32),
             rng.standard_normal((bs, heads, hd)).astype(np.float32))
            for _ in range(num_layers)]


# -- wire format -----------------------------------------------------------

class TestWireFormat:
    def test_fp_roundtrip_bit_exact(self):
        """tier A -> wire -> tier B must hand revival IDENTICAL bytes:
        the dest tier's get() equals the source tier's get() exactly."""
        rng = np.random.default_rng(0)
        src, dst = _tier(), _tier()
        key = (5, 6, 7, 8)
        layers = _layers(rng)
        src.put(key, layers)
        blob = kvxfer.encode_tier_blob(src, prefix_digest(key))
        assert blob is not None
        got_key, blobs, nbytes = kvxfer.decode_entry(blob, dst.int8)
        assert got_key == key
        assert dst.insert_encoded(got_key, blobs, nbytes)
        a, b = src.get(key), dst.get(key)
        for (k0, v0), (k1, v1) in zip(a, b):
            assert np.array_equal(k0, k1) and k0.dtype == k1.dtype
            assert np.array_equal(v0, v1) and v0.dtype == v1.dtype
        assert dst.nbytes == src.nbytes

    def test_int8_roundtrip_blob_exact(self):
        """int8 blobs ship quantized values AND their python-float
        scales verbatim — dequantization on the puller is bit-identical
        to the source's own revival."""
        rng = np.random.default_rng(1)
        src, dst = _tier(int8=True), _tier(int8=True)
        key = (9, 10, 11)
        src.put(key, _layers(rng))
        ent = src.entry_by_digest(prefix_digest(key))
        assert ent is not None
        _, src_blobs, _ = ent
        blob = kvxfer.encode_tier_blob(src, prefix_digest(key))
        got_key, blobs, nbytes = kvxfer.decode_entry(blob, True)
        assert got_key == key
        for (kq0, ks0, vq0, vs0, dt0), (kq1, ks1, vq1, vs1, dt1) in zip(
                src_blobs, blobs):
            assert np.array_equal(kq0, kq1) and np.array_equal(vq0, vq1)
            assert ks0 == ks1 and type(ks1) is float
            assert vs0 == vs1 and type(vs1) is float
            assert np.dtype(dt0) == np.dtype(dt1)
        assert dst.insert_encoded(got_key, blobs, nbytes)
        for (k0, v0), (k1, v1) in zip(src.get(key), dst.get(key)):
            assert np.array_equal(k0, k1) and np.array_equal(v0, v1)

    def test_corruption_raises_never_decodes(self):
        rng = np.random.default_rng(2)
        src = _tier()
        key = (1, 2, 3)
        src.put(key, _layers(rng))
        blob = kvxfer.encode_tier_blob(src, prefix_digest(key))
        # bit-rot in the npz body -> crc mismatch
        mid = len(blob) // 2
        torn = blob[:mid] + bytes(b ^ 0xFF for b in blob[mid:mid + 8]) \
            + blob[mid + 8:]
        with pytest.raises(kvxfer.KVXferError):
            kvxfer.decode_entry(torn, False)
        # truncation
        with pytest.raises(kvxfer.KVXferError):
            kvxfer.decode_entry(blob[: len(blob) // 3], False)
        with pytest.raises(kvxfer.KVXferError):
            kvxfer.decode_entry(b"", False)
        # encoding-mode mismatch (fp blob into an int8 tier)
        with pytest.raises(kvxfer.KVXferError):
            kvxfer.decode_entry(blob, True)

    def test_unknown_digest_is_none(self):
        assert kvxfer.encode_tier_blob(_tier(), "00000000") is None


# -- pull -> revive end to end ---------------------------------------------

SYSTEM = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8]
PROMPT = SYSTEM + [21, 22, 23, 24]


def test_pull_then_revive_byte_identical(model_and_vars):
    """Prefill engine demotes on finish; a decode engine pulls the
    blocks over HTTP and must stream the SAME tokens while actually
    reviving (not re-prefilling) — and both stay on one compiled
    step."""
    model, variables = model_and_vars
    src_eng = _engine(model, variables, host_tier_bytes=1 << 20,
                      demote_finished=True)
    want = src_eng.generate([PROMPT], max_new_tokens=8)[0]
    demoted = src_eng.obs.get("ptpu_kv_tier_demoted_blocks_total")
    assert demoted.labels(reason="finish").value > 0
    assert src_eng.host_tier.contains(tuple(PROMPT[:4]))
    fe = ServeFrontend(src_eng, warmup=False)
    fe.start()
    try:
        dst_eng = _engine(model, variables, host_tier_bytes=1 << 20)
        metrics = kvxfer.KVXferMetrics(dst_eng.obs)
        pulled = kvxfer.pull_prefix(
            dst_eng.host_tier, fe.url, PROMPT,
            dst_eng.cache.block_size, metrics=metrics)
        assert pulled >= len(PROMPT) // dst_eng.cache.block_size
        assert metrics.blocks.value == pulled
        assert metrics.pulls.value == 1 and metrics.fallbacks.value == 0
        assert metrics.bytes.value > 0
        got = dst_eng.generate([PROMPT], max_new_tokens=8)[0]
        assert got == want
        assert dst_eng.obs.get(
            "ptpu_kv_tier_revived_blocks_total").value > 0
        assert dst_eng.step_graph.compiles == 1
        dst_eng.cache.assert_quiesced()
        # pulling again is a no-op: everything is already resident
        assert kvxfer.pull_prefix(
            dst_eng.host_tier, fe.url, PROMPT,
            dst_eng.cache.block_size, metrics=metrics) == 0
        assert metrics.pulls.value == 1
    finally:
        fe.stop()


def test_pull_dead_source_falls_back_clean(model_and_vars):
    """A refused connect counts ONE fallback, inserts nothing, and the
    engine behind the untouched tier still answers correctly."""
    model, variables = model_and_vars
    eng = _engine(model, variables, host_tier_bytes=1 << 20)
    metrics = kvxfer.KVXferMetrics(eng.obs)
    inserted = kvxfer.pull_prefix(
        eng.host_tier, "http://127.0.0.1:9", PROMPT,
        eng.cache.block_size, metrics=metrics)
    assert inserted == 0
    assert metrics.fallbacks.value == 1 and metrics.blocks.value == 0
    assert len(eng.host_tier) == 0
    reference = _engine(model, variables).generate(
        [PROMPT], max_new_tokens=6)[0]
    assert eng.generate([PROMPT], max_new_tokens=6)[0] == reference
    eng.cache.assert_quiesced()


def test_pull_corrupted_wire_falls_back(model_and_vars, monkeypatch):
    """chaos bit-rot on the pulled blob: the crc catches it, nothing
    enters the tier, the fallback is counted."""
    model, variables = model_and_vars
    src_eng = _engine(model, variables, host_tier_bytes=1 << 20,
                      demote_finished=True)
    src_eng.generate([PROMPT], max_new_tokens=8)
    fe = ServeFrontend(src_eng, warmup=False)
    fe.start()
    monkeypatch.setenv("PTPU_CHAOS_KVXFER_CORRUPT", "1000")
    chaos.reset()
    try:
        dst = _tier()
        reg = MetricsRegistry()
        metrics = kvxfer.KVXferMetrics(reg)
        assert kvxfer.pull_prefix(dst, fe.url, PROMPT, 4,
                                  metrics=metrics) == 0
        assert metrics.fallbacks.value == 1
        assert len(dst) == 0
    finally:
        fe.stop()
        monkeypatch.delenv("PTPU_CHAOS_KVXFER_CORRUPT")
        chaos.reset()


def test_kvblocks_route_404s(model_and_vars):
    model, variables = model_and_vars
    eng = _engine(model, variables, host_tier_bytes=1 << 20)
    fe = ServeFrontend(eng, warmup=False)
    fe.start()
    try:
        status, _ = http_get(fe.url + "/kvblocks/ffffffff")
        assert status == 404
        status, _ = http_get(fe.url + "/kvblocks/")
        assert status == 404
    finally:
        fe.stop()


# -- phase-aware routing (no sockets: fake replica states) -----------------

def _fake_router(n=3, **kw):
    router = Router([f"http://127.0.0.1:{9000 + i}" for i in range(n)],
                    **kw)
    for r in router.replicas:
        r.ready = True
    return router


class TestPhaseRouting:
    def test_prefill_heavy_routes_to_prefill_replica(self):
        router = _fake_router(kv_transfer=True)
        router.replicas[0].phase = "prefill"
        router.replicas[1].phase = "decode"
        # 40 prompt tokens vs 4 decode tokens: prefill-heavy
        order, _, _, _, want = router._plan([1] * 40, 4)
        assert want == "prefill"
        assert order[0] is router.replicas[0]
        # every ready replica is still a candidate (failover)
        assert set(order) == set(router.replicas)

    def test_decode_heavy_routes_to_decode_replica(self):
        router = _fake_router(kv_transfer=True)
        router.replicas[0].phase = "prefill"
        router.replicas[1].phase = "decode"
        order, _, _, _, want = router._plan([1, 2], 32)
        assert want == "decode"
        assert order[0] is router.replicas[1]

    def test_mixed_fleet_routes_as_before(self):
        """No specialists -> no phase pool: the sticky hash primary
        leads and no phase routing is counted."""
        router = _fake_router()
        prompt = list(range(12))
        order, _, sticky, _, want = router._plan(prompt, 4)
        assert want is None
        assert order[0] is sticky

    def test_all_specialists_same_phase_degenerates(self):
        """A fleet that is ALL prefill has no one to specialize
        against: route over the whole ready set."""
        router = _fake_router()
        for r in router.replicas:
            r.phase = "prefill"
        _, _, _, _, want = router._plan([1] * 40, 4)
        assert want is None

    def test_kv_transfer_keeps_target_and_reports_hint(self):
        """With kv_transfer the directory pick is NOT promoted — the
        plan reports (dir_pick, dir_len) for the hint headers; without
        it the advertiser jumps to the front (the old behavior)."""
        prompt = list(range(12))
        d8 = prefix_digest(prompt[:8])
        router = _fake_router(kv_transfer=True)
        sticky = router.plan_route(prompt)[0]
        advertiser = next(r for r in router.replicas if r is not sticky)
        advertiser.prefixes = {(8, d8): "host"}
        order, dir_pick, _, dir_len, _ = router._plan(prompt)
        assert order[0] is sticky           # target unchanged
        assert dir_pick is advertiser and dir_len == 8
        router.kv_transfer = False
        order, dir_pick, _, dir_len, _ = router._plan(prompt)
        assert order[0] is advertiser       # re-route, as before

    def test_register_carries_phase(self):
        router = Router([])
        r = router.register_replica("http://127.0.0.1:9009",
                                    phase="decode")
        assert r.phase == "decode"
        # a heartbeat without a phase leaves it alone
        r2 = router.register_replica("http://127.0.0.1:9009")
        assert r2 is r and r.phase == "decode"
        # junk phases are ignored, not crashes
        router.register_replica("http://127.0.0.1:9009", phase="bogus")
        assert r.phase == "decode"


# -- byte tokenizer + front door -------------------------------------------

class TestTokenizer:
    def test_roundtrip_and_determinism(self):
        tok = ByteTokenizer(VOCAB, seed=0)
        for text in ("", "hello", "fleet ✓ 漢字", "a" * 100):
            ids = tok.encode(text)
            assert len(ids) == 2 * len(text.encode("utf-8"))
            assert all(0 <= t < VOCAB for t in ids)
            assert tok.decode(ids) == text
        assert ByteTokenizer(VOCAB, seed=0).encode("same") == \
            tok.encode("same")
        assert ByteTokenizer(VOCAB, seed=1).encode("same") != \
            tok.encode("same")

    def test_rejects_bad_input(self):
        tok = ByteTokenizer(VOCAB, seed=0)
        with pytest.raises(ValueError):
            tok.decode([tok.encode("ab")[0]])          # odd length
        with pytest.raises(ValueError):
            tok.decode([VOCAB + 5, VOCAB + 6])         # out of alphabet
        with pytest.raises(ValueError):
            ByteTokenizer(8)                           # vocab too small


@pytest.fixture(scope="module")
def warm_fe(model_and_vars):
    model, variables = model_and_vars
    fe = ServeFrontend(_engine(model, variables)).start()
    yield fe
    fe.stop()


class TestFrontDoor:
    def test_tokenize_route(self, warm_fe):
        conn = HTTPConnection(warm_fe.host, warm_fe.port, timeout=30)
        try:
            conn.request("POST", "/v1/tokenize",
                         body=json.dumps({"text": "hi"}).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
        finally:
            conn.close()
        assert resp.status == 200
        want = ByteTokenizer(VOCAB, seed=0).encode("hi")
        assert body["tokens"] == want and body["count"] == len(want)
        assert body["vocab"] == VOCAB

    def test_tokenize_rejects_non_string(self, warm_fe):
        conn = HTTPConnection(warm_fe.host, warm_fe.port, timeout=30)
        try:
            conn.request("POST", "/v1/tokenize",
                         body=json.dumps({"text": [1, 2]}).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
        finally:
            conn.close()
        assert resp.status == 400

    def test_string_prompt_equals_pretokenized(self, warm_fe):
        text = "route me"
        ids = ByteTokenizer(VOCAB, seed=0).encode(text)
        by_ids = collect_stream(warm_fe.url,
                                {"prompt": ids, "max_new_tokens": 6})
        by_text = collect_stream(warm_fe.url,
                                 {"prompt": text, "max_new_tokens": 6})
        assert by_ids["status"] == by_text["status"] == 200
        assert by_text["done"] and by_text["tokens"] == by_ids["tokens"]
