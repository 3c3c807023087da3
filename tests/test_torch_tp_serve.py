"""The port's tensor-parallel serving (paddle_tpu_torch/parallel/
serve_collective.py, the engine's tp_size over worker ranks,
engine/tp_worker.py) against the JAX package's: a mirror of
tests/test_tp_serve.py but its lint gate (`analysis/` is not ported),
plus cross-package checks:

- the quantized collective against exact sums and against JAX's
  shard_map collective on the same shard inputs (1e-6), wire bytes;
- pool_shape and the divisibility checks, made before any process
  starts;
- tp=1 is the one-rank engine (no process group, no worker); tp=2 fp
  streams equal tp=1's, JAX's tp=2's and JAX's tp=1's; int8 completes
  with the probe observed, and reset_stats keeps both static series;
- speculation, COW forks and host-tier revival are unchanged under tp=2;
- the int8 tier's compress scales are equal on both ranks and equal to
  JAX's (tp=2 and tp=1);
- a host-tier spill written by a port tp=2 engine loads in a JAX tp=1
  engine, and the reverse;
- from_saved_model(tp_size=2) serves a JAX export as JAX's tp=2 engine
  and the port's tp=1 engine do;
- a ServeFrontend over a tp=2 engine streams what tp=1 streams, and
  /metrics shows ptpu_serve_tp_size 2;
- a rank holds its weight shard only; an idle worker outlives the
  collectives' timeout, and a dead one makes the next step raise;
- CausalLM.prefill_chunk_paged(tp=) at tp=2 gives JAX's tp=2 prefill.

Ranks run on the CPU over gloo: a tp=2 engine starts one worker
process; each test closes every engine it starts (the `closing`
fixture), so no worker outlives its test. The collective cases run two
gloo ranks as two threads of the test process.
"""

import copy
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.engine.engine import ServeEngine as JaxServeEngine
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu.parallel import MeshConfig as JaxMeshConfig
from paddle_tpu.parallel import make_mesh as jax_make_mesh
from paddle_tpu.parallel import serve_collective as jsc
from paddle_tpu_torch.engine.engine import ServeEngine
from paddle_tpu_torch.engine import tp_worker
from paddle_tpu_torch.engine.paged_cache import PagedKVCache
from paddle_tpu_torch.engine.tp_worker import param_bytes
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.models.convert import to_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.parallel import serve_collective as sc
from paddle_tpu_torch.parallel.collective import AxisGroup
from paddle_tpu_torch.parallel.distributed import private_groups, serve_store
from paddle_tpu_torch.parallel.sharding import (serve_tp_rules, shard_module,
                                                shard_variables)
from paddle_tpu_torch.utils.tree import flatten_with_keys

pytestmark = pytest.mark.serve

VOCAB = 61
PROMPTS = [[7, 3, 7, 3, 11, 2], [1, 2, 3, 1, 2, 3, 1, 2],
           [5, 9, 2, 8], [4, 4, 4, 4, 4, 4, 4]]


@pytest.fixture(scope="module")
def models():
    """tests/test_tp_serve.py's GQA fixture (4 query heads over 2 kv
    heads: at tp=2 each rank holds 2 over 1), its JAX init weights loaded
    into the port's CausalLM."""
    jm = JaxCausalLM(vocab=VOCAB, model_dim=32, num_heads=4, num_layers=2,
                     ffn_dim=64, dropout=0.0, max_len=64, num_kv_heads=2)
    jvars = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tm = CausalLM(VOCAB, model_dim=32, num_heads=4, num_layers=2,
                  ffn_dim=64, dropout=0.0, max_len=64, num_kv_heads=2,
                  device="cpu")
    load_jax_params(tm, jax.device_get(jvars))
    return jm, jvars, tm


@pytest.fixture
def closing():
    """Engines a test starts; closed (workers joined) at teardown, and
    their workers must have exited 0."""
    engines = []
    yield engines
    for eng in engines:
        eng.close()
    for eng in engines:
        assert all(c == 0 for c in eng.worker_exit_codes), \
            eng.worker_exit_codes


def _kw(**kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_prefill_tokens", 32)
    kw.setdefault("tile_q", 4)
    return kw


def _with_mode(mode, build):
    """Build with PTPU_SERVE_ALLREDUCE pinned to `mode` (both engines
    read it once, when built)."""
    prev = os.environ.get("PTPU_SERVE_ALLREDUCE")
    if mode is not None:
        os.environ["PTPU_SERVE_ALLREDUCE"] = mode
    try:
        return build()
    finally:
        if mode is not None:
            if prev is None:
                os.environ.pop("PTPU_SERVE_ALLREDUCE", None)
            else:
                os.environ["PTPU_SERVE_ALLREDUCE"] = prev


def _engine(models, closing=None, mode=None, **kw):
    eng = _with_mode(mode, lambda: ServeEngine(
        models[2], device="cpu", registry=MetricsRegistry(), **_kw(**kw)))
    if closing is not None:
        closing.append(eng)
    return eng


def _jax_engine(models, mode=None, **kw):
    return _with_mode(mode, lambda: JaxServeEngine(
        models[0], models[1], registry=JaxRegistry(), **_kw(**kw)))


def _ranks(n, fn):
    """fn(group) on each of n gloo ranks, run as n threads of this
    process; returns the results in rank order."""
    store = serve_store(60.0)
    out, errs = [None] * n, []

    def rank(r):
        try:
            g = private_groups(store if r == 0 else store.port, r, n,
                               ("gloo",), 60.0)["0:gloo"]
            out[r] = fn(AxisGroup(g, "gloo"))
        except BaseException as e:       # surfaced on the test thread
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errs:
        raise errs[0]
    return out


def _jax_collective(x, fn):
    """fn over JAX's tp mesh of x.shape[0] CPU devices, x's rows the
    shards; returns rank 0's output."""
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.parallel.compat import shard_map

    mesh = jax_make_mesh(JaxMeshConfig(tp=x.shape[0]),
                         devices=jax.devices()[:x.shape[0]])
    out = shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                    in_specs=(P("tp"),), out_specs=P("tp"),
                    check_vma=False)(jnp.asarray(x))
    return np.asarray(out)[0]


# -- collective-level --------------------------------------------------------

class TestServeCollective:
    def test_resolve_mode(self, monkeypatch):
        monkeypatch.delenv("PTPU_SERVE_ALLREDUCE", raising=False)
        assert sc.resolve_mode() == "int8"
        monkeypatch.setenv("PTPU_SERVE_ALLREDUCE", "fp")
        assert sc.resolve_mode() == "fp"
        monkeypatch.setenv("PTPU_SERVE_ALLREDUCE", "bf8")
        with pytest.raises(ValueError):
            sc.resolve_mode()

    def test_int8_allreduce_close_to_psum(self):
        """The quantized collective is the exact sum within per-chunk
        int8 error: |err| <= tp * chunk_absmax / 127 per element."""
        x = np.random.RandomState(0).randn(2, 8, 320).astype(np.float32)

        def body(g):
            v = torch.from_numpy(x[g.rank])
            return (sc.serve_all_reduce(v, g, "fp", chunk=64).numpy(),
                    sc.serve_all_reduce(v, g, "int8", chunk=64).numpy())

        (exact, quant), (exact1, quant1) = _ranks(2, body)
        np.testing.assert_array_equal(exact, exact1)
        np.testing.assert_array_equal(quant, quant1)
        np.testing.assert_allclose(exact, x.sum(0), rtol=1e-6, atol=1e-6)
        bound = 2.0 * np.abs(x).max() / 127.0 + 1e-6
        assert np.max(np.abs(quant - exact)) <= bound

    def test_int8_allreduce_handles_ragged_and_zero_chunks(self):
        """Lengths not divisible by the chunk pad internally; an
        all-zero chunk must not divide by zero (scale floor)."""
        x = np.zeros((2, 3, 37), np.float32)
        x[:, 0, :5] = [[1.0, -2.0, 0.5, 3.0, -0.25]] * 2
        out = _ranks(2, lambda g: sc.quantized_all_reduce(
            torch.from_numpy(x[g.rank]), g, chunk=16).numpy())[0]
        assert np.all(np.isfinite(out))
        np.testing.assert_allclose(out, x.sum(0), atol=0.05)

    def test_wire_bytes_accounting(self):
        d = 512
        assert sc.allreduce_wire_bytes(d, "fp", 1) == 0
        assert sc.allreduce_wire_bytes(d, "int8", 1) == 0
        assert sc.allreduce_wire_bytes(d, "fp", 2) == 2 * (1 / 2) * 4 * d
        assert sc.allreduce_wire_bytes(d, "int8", 2, chunk=256) == \
            1 * (d + 4 * d / 256)
        assert sc.allreduce_wire_bytes(d, "int8", 2) < \
            sc.allreduce_wire_bytes(d, "fp", 2)
        for mode in ("fp", "int8"):
            for tp in (1, 2, 4):
                assert sc.allreduce_wire_bytes(d, mode, tp) == \
                    jsc.allreduce_wire_bytes(d, mode, tp)

    @pytest.mark.parametrize("case", ["chunk64", "ragged_zero"])
    def test_quantized_all_reduce_matches_jax(self, case):
        """The same shard inputs give JAX's numbers within 1e-6."""
        if case == "chunk64":
            x = np.random.RandomState(1).randn(2, 8, 320).astype(np.float32)
            chunk = 64
        else:
            x = np.zeros((2, 3, 37), np.float32)
            x[0, 0, :5] = [1.0, -2.0, 0.5, 3.0, -0.25]
            x[1, 1, 3:9] = [7.0, -1e-3, 0.0, 2.5, -6.0, 1e-6]
            chunk = 16
        port = _ranks(2, lambda g: sc.quantized_all_reduce(
            torch.from_numpy(x[g.rank]), g, chunk=chunk).numpy())
        want = _jax_collective(
            x, lambda v: jsc.quantized_all_reduce(v, "tp", chunk=chunk))
        for got in port:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- cache-level ---------------------------------------------------------------

class TestPoolSharding:
    def test_pool_shape_divides_kv_heads(self):
        c = PagedKVCache(num_blocks=8, block_size=4, num_layers=1,
                         num_kv_heads=4, head_dim=8, device="cpu",
                         registry=MetricsRegistry())
        assert c.pool_shape() == (8, 4, 4, 8)
        assert c.pool_shape(2) == (8, 4, 2, 8)
        with pytest.raises(ValueError):
            c.pool_shape(3)
        with pytest.raises(ValueError):
            c.pool_shape(0)
        half = PagedKVCache(num_blocks=8, block_size=4, num_layers=1,
                            num_kv_heads=4, head_dim=8, device="cpu",
                            registry=MetricsRegistry(), tp_size=2)
        assert tuple(half.pools[0][0].shape) == half.pool_shape()
        assert half.per_chip_pool_bytes() * 2 == c.per_chip_pool_bytes()

    def test_ctor_rejects_indivisible_tp(self):
        for tp in (3, 0):
            with pytest.raises(ValueError, match="tp_size"):
                PagedKVCache(num_blocks=8, block_size=4, num_layers=1,
                             num_kv_heads=4, head_dim=8, device="cpu",
                             registry=MetricsRegistry(), tp_size=tp)

    def test_engine_rejects_indivisible_heads(self, models, monkeypatch):
        """Both checks raise before any process starts."""
        with pytest.raises(ValueError, match="tp_size"):
            _engine(models, tp_size=3)                  # 4 heads % 3
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(ValueError, match="needs 2 CUDA devices"):
            ServeEngine(models[2], registry=MetricsRegistry(), tp_size=2,
                        **_kw())                         # no cards


# -- engine-level parity -------------------------------------------------------

class TestTPParity:
    def test_tp1_is_legacy(self, models):
        """tp_size=1 takes the one-rank engine: the same tokens as an
        engine built without the knob, no process group, no worker."""
        base = _engine(models)
        tp1 = _engine(models, tp_size=1)
        assert tp1._serve_tp is None and tp1._tp is None
        assert tp1.step_graph.tp is None
        assert tp1.model is models[2]
        assert tp1.generate(PROMPTS, max_new_tokens=10) == \
            base.generate(PROMPTS, max_new_tokens=10)
        assert tp1.rank_state()[0]["rank"] == 0 and tp1.worker_exit_codes == []

    def test_tp2_fp_token_identical(self, models, closing):
        """fp tp=2 reproduces the tp=1 streams, JAX's tp=2 streams and
        JAX's tp=1 streams; a rank holds half the pool bytes; the whole
        drain stays on the one eager program."""
        ref = _engine(models, mode="fp")
        eng = _engine(models, closing, mode="fp", tp_size=2)
        want = ref.generate(PROMPTS, max_new_tokens=12)
        got = eng.generate(PROMPTS, max_new_tokens=12)
        assert got == want
        assert got == _jax_engine(models, mode="fp", tp_size=2).generate(
            PROMPTS, max_new_tokens=12)
        assert got == _jax_engine(models, mode="fp").generate(
            PROMPTS, max_new_tokens=12)
        assert eng.step_graph.compiles == 1
        states = eng.rank_state()
        assert [s["compiles"] for s in states] == [1, 1]
        for s in states:
            assert s["pool_bytes"] * 2 == ref.cache.per_chip_pool_bytes()
        # a rank holds its weight shard, the engine's model is rank 0's
        tree = to_jax_params(models[2])
        assert [s["param_bytes"] for s in states] == [
            4 * sum(a.size for _, a in flatten_with_keys(
                shard_variables(tree, serve_tp_rules(), r, 2)))
            for r in range(2)]
        assert states[0]["param_bytes"] == param_bytes(eng.model)
        assert states[0]["param_bytes"] < param_bytes(models[2])
        assert eng.obs.get("ptpu_serve_tp_size").value == 2.0
        assert ref.obs.get("ptpu_serve_tp_size").value == 1.0
        assert eng.debug_state()["tp"] == "ServeTP(size=2, mode='fp')"
        eng.cache.assert_quiesced()

    def test_tp2_int8_completes_with_probe_observed(self, models, closing):
        """int8 mode: streams may drift within quantization noise, so
        the gates are completion, one program, and the allreduce probe
        in the mode-labelled histogram, kept by reset_stats."""
        ref = _engine(models, mode="fp")
        eng = _engine(models, closing, mode="int8", tp_size=2)
        want = ref.generate(PROMPTS, max_new_tokens=10)
        got = eng.generate(PROMPTS, max_new_tokens=10)
        assert [len(t) for t in got] == [len(t) for t in want]
        assert eng.step_graph.compiles == 1
        hist = eng.obs.get("ptpu_serve_allreduce_ms").children()
        assert ("int8",) in hist and hist[("int8",)].count >= 1
        eng.reset_stats()
        assert eng.obs.get("ptpu_serve_tp_size").value == 2.0
        hist = eng.obs.get("ptpu_serve_allreduce_ms").children()
        assert hist[("int8",)].count == 1
        eng.cache.assert_quiesced()


# -- engine features ride unchanged under tp=2 ---------------------------------

class TestTPFeatureParity:
    def test_spec_decode_unchanged(self, models, closing):
        """Speculative decoding under tp=2/fp equals the spec-off tp=2
        run token for token."""
        prompts = [[1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2, 3]]
        base = _engine(models, closing, mode="fp", tp_size=2)
        spec = _engine(models, closing, mode="fp", tp_size=2, spec_k=3)
        want = base.generate(prompts, max_new_tokens=14)
        got = spec.generate(prompts, max_new_tokens=14)
        assert got == want
        assert spec.obs.get("ptpu_spec_drafted_tokens_total").value > 0
        assert spec.step_graph.compiles == 1
        spec.cache.assert_quiesced()

    @pytest.mark.parametrize("prompt", [[1, 2, 3, 1, 2, 3, 1, 2],
                                        [1, 2, 3, 1, 2, 3, 1]],
                             ids=["full_blocks", "partial_block"])
    def test_cow_fork_unchanged(self, models, closing, prompt):
        """n=2 parallel sampling under tp=2/fp equals the tp=1 group per
        candidate; a fork sharing a partial block copies it on write
        through every rank's lane copies."""
        ref = _engine(models, mode="fp")
        rb = ref.add_request(list(prompt), max_new_tokens=12, n=2)
        res_ref = ref.run()
        eng = _engine(models, closing, mode="fp", tp_size=2)
        re_ = eng.add_request(list(prompt), max_new_tokens=12, n=2)
        res_tp = eng.run()
        assert res_tp[re_.req_id] == res_ref[rb.req_id]
        assert res_tp[re_.forks[0].req_id] == res_ref[rb.forks[0].req_id]
        assert (eng.cache.cow_copies > 0) == (len(prompt) % 4 > 0)
        assert eng.cache.cow_copies == ref.cache.cow_copies
        assert eng.step_graph.compiles == 1
        eng.cache.assert_quiesced()

    def test_host_tier_revival_unchanged(self, models, closing):
        """A tight tp=2 pool preempts, demotes global blocks to the host
        tier (every rank's head slices joined) and revives them into
        each rank's slices; output equals the roomy tp=2 run."""
        tails = [[21, 22, 23, 24], [31, 32, 33, 34], [41, 42, 43, 44]]
        prompts = [[7, 3, 7, 3] + t for t in tails]
        roomy = _engine(models, closing, mode="fp", tp_size=2,
                        max_batch_size=3)
        want = roomy.generate(prompts, max_new_tokens=12)
        tight = _engine(models, closing, mode="fp", tp_size=2,
                        max_batch_size=3, num_blocks=9,
                        host_tier_bytes=1 << 20)
        got = tight.generate(prompts, max_new_tokens=12)
        assert got == want
        assert sum(r.preemptions for r in tight.finished.values()) > 0
        demoted = tight.obs.get("ptpu_kv_tier_demoted_blocks_total")
        assert demoted.labels(reason="preempt").value > 0
        assert tight.cache.tier_revivals > 0
        assert tight.step_graph.compiles == 1
        tight.cache.assert_quiesced()


# -- across packages -------------------------------------------------------------

def _cold_churn_warm(eng, prompt):
    """tests/test_torch_kvcompress.py's traffic: the prompt, fillers that
    evict its fp copies into the int8 tier, the prompt again."""
    out = [eng.generate([prompt], max_new_tokens=6)]
    out.append(eng.generate([[50] * 8], max_new_tokens=8))
    for i in range(3):
        out.append(eng.generate([[30 + i] * 16], max_new_tokens=12))
    out.append(eng.generate([prompt], max_new_tokens=6))
    return out


def test_compress_lanes_reduce_the_scale_over_ranks():
    """The mechanism, exactly: two ranks each holding half the kv heads
    of the same blocks quantize with the MAX of their scales, so their
    scales equal the one-rank cache's and JAX's `quantize_block` of the
    whole block bit for bit, and their int8 bytes are the head slices of
    the one-rank bytes."""
    from paddle_tpu.quant.int8_compute import quantize_block as jax_quant
    from paddle_tpu_torch.parallel.collective import all_reduce

    rs = np.random.RandomState(3)
    kw = dict(num_layers=2, num_blocks=6, block_size=4, num_kv_heads=2,
              head_dim=8, device="cpu", compress_blocks=4)
    glob = rs.randn(2, 2, 6, 4, 2, 8).astype(np.float32)   # [L, k|v, ...]
    glob[:, :, :, :, 1] *= 5.0      # the second head holds the abs-max
    src = torch.tensor([1, 2, 5, 0, 0, 0, 0, 0])
    dst = torch.tensor([1, 2, 3, 0, 0, 0, 0, 0])

    def fill(cache, heads):
        for li, pair in enumerate(cache.pools):
            for kv, t in enumerate(pair):
                t.copy_(torch.from_numpy(glob[li, kv][:, :, heads]))
        return cache

    one = fill(PagedKVCache(registry=MetricsRegistry(), **kw), slice(None))
    one.compress_lanes(src, dst)

    def rank(g):
        c = fill(PagedKVCache(registry=MetricsRegistry(), tp_size=2, **kw),
                 slice(g.rank, g.rank + 1))
        c.compress_lanes(src, dst, lambda t: all_reduce(t, g, "max"))
        return c

    for r, c in enumerate(_ranks(2, rank)):
        for li in range(2):
            for kv in range(2):
                want_q, want_s = jax_quant(jnp.asarray(
                    glob[li, kv][src.numpy()]))
                np.testing.assert_array_equal(
                    c.qscales[li][kv][dst].numpy(), np.asarray(want_s))
                np.testing.assert_array_equal(
                    c.qscales[li][kv].numpy(), one.qscales[li][kv].numpy())
                np.testing.assert_array_equal(
                    c.qpools[li][kv].numpy(),
                    one.qpools[li][kv][:, :, r:r + 1].numpy())
                np.testing.assert_array_equal(
                    c.qpools[li][kv][dst].numpy(),
                    np.asarray(want_q)[:, :, r:r + 1])


def test_compress_scales_equal_across_ranks_and_jax(models, closing):
    """The int8 tier under tp=2: both ranks hold the same scales bit for
    bit, and they are JAX's (tp=2 and tp=1) up to the projections'
    float32 rounding (a rank's own abs-max would be off by whole
    factors); the direct-read streams are the JAX engines'. (Direct ==
    promote under tp is held on the card, chip_smoke.py engine_tp.)"""
    prompt = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8, 6, 2]
    kw = dict(num_blocks=16, kv_compress_blocks=24)
    direct = _engine(models, closing, mode="fp", tp_size=2, **kw)
    got = _cold_churn_warm(direct, prompt)
    st = direct.cache.stats()
    assert st["direct_int8_reads"] == 3 and st["compress_total"] > 0
    scales = [s["qscales"] for s in direct.rank_state()]
    want = {}
    for tp in (2, 1):
        ref = _jax_engine(models, mode="fp", tp_size=tp, **kw)
        assert _cold_churn_warm(ref, prompt) == got
        want[tp] = [(np.asarray(k), np.asarray(v))
                    for k, v in ref.cache.qscales]
    for (k0, v0), (k1, v1) in zip(*scales):
        np.testing.assert_array_equal(k0, k1)
        np.testing.assert_array_equal(v0, v1)
    for tp in (2, 1):
        for got_kv, want_kv in zip(scales[0], want[tp]):
            for g, w in zip(got_kv, want_kv):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    direct.cache.assert_quiesced()


@pytest.mark.parametrize("writer", ["port_tp2", "jax_tp1"])
def test_spill_loads_across_packages_and_tp(models, closing, tmp_path,
                                            writer):
    """A host-tier spill keeps the global layout: one written by a port
    tp=2 engine warm-starts a JAX tp=1 engine, and a JAX tp=1 spill warm-
    starts a port tp=2 engine; the reader revives the prompt without
    re-prefilling it and streams the writer's tokens."""
    prompt = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8, 31, 32, 33, 34]
    kw = dict(num_blocks=10, host_tier_bytes=1 << 20)
    port = lambda **k: _engine(models, closing, mode="fp", tp_size=2, **k)
    ref = lambda **k: _jax_engine(models, mode="fp", **k)
    make_src, make_dst = (port, ref) if writer == "port_tp2" else (ref, port)
    src = make_src(demote_finished=True, **kw)
    want = src.generate([prompt], max_new_tokens=6)
    assert src.host_tier.spill(str(tmp_path)) > 0
    dst = make_dst(tier_spill_dir=str(tmp_path), **kw)
    assert len(dst.host_tier) == len(src.host_tier)
    assert dst.generate([prompt], max_new_tokens=6) == want
    assert dst.cache.stats()["tier_revivals"] == len(prompt) // 4
    assert dst.prefill_tokens_computed == 1


def test_from_saved_model_tp2_serves_the_export(tmp_path, closing):
    """ServeEngine.from_saved_model(..., tp_size=2) over a JAX export
    (GQA 4 over 2 heads) streams what JAX's from_saved_model at tp=2 and
    the port at tp=1 stream."""
    from paddle_tpu.testing.fixtures import export_causal_lm

    path, _, _ = export_causal_lm(str(tmp_path / "lm"), model_dim=32,
                                  num_heads=4, num_kv_heads=2)
    port = _with_mode("fp", lambda: ServeEngine.from_saved_model(
        path, device="cpu", tp_size=2, registry=MetricsRegistry(),
        **_kw()))
    closing.append(port)
    assert port.tp_size == 2 and port.tp_backend == "gloo"
    got = port.generate(PROMPTS, max_new_tokens=10)
    ref = _with_mode("fp", lambda: JaxServeEngine.from_saved_model(
        path, tp_size=2, registry=JaxRegistry(), **_kw()))
    assert got == ref.generate(PROMPTS, max_new_tokens=10)
    one = ServeEngine.from_saved_model(path, device="cpu",
                                       registry=MetricsRegistry(), **_kw())
    assert got == one.generate(PROMPTS, max_new_tokens=10)
    # only the shard stays: rank 0 holds less than the whole model
    assert port.rank_state()[0]["param_bytes"] < param_bytes(one.model)


def test_frontend_over_tp2_streams_tp1(models, closing):
    """One ServeFrontend over a tp=2 CPU engine streams what a tp=1
    engine generates, and its /metrics shows ptpu_serve_tp_size 2."""
    from paddle_tpu_torch.serve.frontend import ServeFrontend
    from paddle_tpu_torch.serve.sse import (collect_stream, http_get,
                                            parse_prometheus_values)

    prompt = [5, 9, 2, 7]
    want = _engine(models, mode="fp").generate([prompt],
                                               max_new_tokens=12)[0]
    fe = ServeFrontend(_engine(models, closing, mode="fp", tp_size=2),
                       drain_deadline_s=10.0).start()
    try:
        out = collect_stream(fe.url, {"prompt": prompt,
                                      "max_new_tokens": 12})
        assert out["status"] == 200 and out["done"]
        assert out["tokens"] == want
        status, text = http_get(fe.url + "/metrics")
        assert status == 200
        vals = parse_prometheus_values(text)
        assert vals["ptpu_serve_tp_size"] == 2.0
        assert vals["ptpu_engine_compiles"] == 1.0
    finally:
        fe.stop()


def test_idle_worker_outlives_the_timeout_and_a_dead_one_raises(
        models, monkeypatch):
    """A worker waits for its next command without a deadline: a tp=2
    engine left idle past the collectives' timeout still serves tp=1's
    streams. A worker that dies makes the next step raise at once."""
    monkeypatch.setattr(tp_worker, "TP_TIMEOUT_S", 3.0)
    want = _engine(models, mode="fp").generate(PROMPTS[:2],
                                               max_new_tokens=6)
    eng = _engine(models, mode="fp", tp_size=2)
    try:
        time.sleep(4.0)
        assert eng.generate(PROMPTS[:2], max_new_tokens=6) == want
        worker = eng._tp.procs[0]
        worker.kill()
        worker.wait()
        with pytest.raises(RuntimeError, match="rank 1 is gone"):
            eng.generate(PROMPTS[:1], max_new_tokens=2)
    finally:
        eng.close()
    assert eng.worker_exit_codes == [-9]


def _cx(variables):
    from paddle_tpu.core.module import Context, _CtxCore
    return Context(_CtxCore(mode="apply", variables=variables, mutated={},
                            rng=None, rng_count=0, training=False))


@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_prefill_chunk_paged_tp2_matches_jax(models, mode):
    """CausalLM.prefill_chunk_paged(tp=) at tp=2 (each rank its weight
    shard and its kv head of the pools; two gloo ranks as threads)
    against JAX's prefill_chunk_paged at tp=2 in the same mode: logits
    on both ranks within 1e-4, each rank's pools the head slice of the
    pools JAX returns (1e-5); in fp mode the port's tp=1 logits too."""
    jm, jvars, tm = models
    prompts = [[5, 9, 2, 11, 7], [3, 1, 4, 1, 5, 9, 2, 6, 5], [8, 8]]
    bs, nb, mb, layers, hd = 4, 16, 4, 2, 8
    b, c = len(prompts), max(len(p) for p in prompts)
    tables = np.zeros((b, mb), np.int32)
    tokens = np.zeros((b, c), np.int32)
    slots = np.zeros((b, c), np.int32)
    for i, p in enumerate(prompts):
        tables[i] = 1 + i * mb + np.arange(mb)
        tokens[i, :len(p)] = p
        slots[i, :len(p)] = [tables[i, j // bs] * bs + j % bs
                             for j in range(len(p))]
    slots = slots.reshape(-1)
    lens = np.array([len(p) for p in prompts], np.int32)
    start = np.zeros(b, np.int32)
    ops = (tokens, start, tables, lens, slots, lens - 1)

    def port(model, tp, heads):
        pools = [(torch.zeros(nb, bs, heads, hd), torch.zeros(nb, bs, heads,
                                                              hd))
                 for _ in range(layers)]
        t = [torch.from_numpy(a) for a in ops]
        with torch.inference_mode():
            logits = model.prefill_chunk_paged(t[0], t[1], pools, *t[2:],
                                               tp=tp)
        return logits.numpy(), pools

    def rank(g):
        shard = shard_module(copy.deepcopy(tm), serve_tp_rules(), g.rank, 2)
        return port(shard, sc.ServeTP(g, 2, mode=mode), 1)

    jtp = jsc.ServeTP(jax_make_mesh(JaxMeshConfig(tp=2),
                                    devices=jax.devices()[:2]), 2, mode=mode)
    jpools = [(jnp.zeros((nb, bs, 2, hd)), jnp.zeros((nb, bs, 2, hd)))
              for _ in range(layers)]
    want, jpools = jax.jit(lambda v, p, *a: jm.prefill_chunk_paged(
        _cx(v), a[0], a[1], p, *a[2:], tp=jtp))(
            jvars, jpools, *[jnp.asarray(a) for a in ops])
    for r, (logits, pools) in enumerate(_ranks(2, rank)):
        np.testing.assert_allclose(logits, np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        for (k, v), (jk, jv) in zip(pools, jpools):
            np.testing.assert_allclose(k[1:].numpy(),
                                       np.asarray(jk)[1:, :, r:r + 1],
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(v[1:].numpy(),
                                       np.asarray(jv)[1:, :, r:r + 1],
                                       atol=1e-5, rtol=1e-5)
    if mode == "fp":
        np.testing.assert_allclose(port(tm, None, 2)[0], np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
