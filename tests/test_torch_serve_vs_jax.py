"""The port's serve layer against the JAX package's, over the wire, in
float32 on the CPU.

Both packages serve the same `export_causal_lm` export
(paddle_tpu/testing/fixtures.py), each as an in-process replica built by
its own `replica.build_frontend` at port 0 (the port's with
`--device cpu`):

- a port `Router` in front of one JAX replica and one port replica
  streams the same greedy tokens whichever replica serves a prompt, and
  both replicas stream them directly too;
- each replica pulls the other's `/kvblocks` blobs (fp f32 and int8)
  through the router's transfer hint and then streams what it streams
  warm from its own pool, with the blocks counted and no fallback;
- after the same traffic the two engines give the same
  `kv_prefix_directory` rows and the same `debug_state`;
- bf16 blobs on the wire are pinned: the port ships a bf16 fp block as
  its raw `|V2` payload, which JAX decodes to `|V2` arrays it cannot
  use (as it loads a bf16 spill), while a JAX bf16 blob decodes in the
  port bit for bit; int8 blobs record the dtype by name in both;
- the port's `--init-seed` replica (no export): the same seed gives the
  same weights, it serves, and its tokenizer is JAX's for that seed.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.engine import HostKVTier as JaxHostKVTier
from paddle_tpu.engine import ServeEngine as JaxServeEngine
from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu.serve import kvxfer as jax_kvxfer
from paddle_tpu.serve import replica as jax_replica
from paddle_tpu.serve.tokenizer import ByteTokenizer as JaxByteTokenizer
from paddle_tpu.testing.fixtures import export_causal_lm
from paddle_tpu_torch.engine import HostKVTier, ServeEngine, prefix_digest
from paddle_tpu_torch.engine.kvtier import to_host
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.serve import kvxfer
from paddle_tpu_torch.serve import replica as port_replica
from paddle_tpu_torch.serve.router import Router, prefix_shard
from paddle_tpu_torch.serve.sse import collect_stream

pytestmark = pytest.mark.serve

VOCAB = 61
SYSTEM = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8]


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    path, _, _ = export_causal_lm(
        str(tmp_path_factory.mktemp("serve_vs_jax") / "lm"), vocab=VOCAB)
    return path


def _replica(pkg, export, *extra):
    """An in-process replica of package `pkg` over `export`, started."""
    mod = jax_replica if pkg == "jax" else port_replica
    argv = ["--model-dir", export, "--port", "0",
            "--drain-deadline-s", "10", "--dir-interval-s", "0.05", *extra]
    if pkg == "port":
        argv += ["--device", "cpu"]
    return mod.build_frontend(mod.build_parser().parse_args(argv)).start()


def _counter_value(registry, name, **labels):
    fam = registry.get(name)
    if fam is None:
        return 0.0
    return (fam.labels(**labels) if labels else fam).value


# objectives a loaded CPU keeps: a JAX replica's first request takes
# 585-776 ms on a busy machine, past the default 500 ms TTFT, and a
# broken objective sheds later prompts (slo_ttft, 503); the router test
# checks streams, and shedding is pinned in test_torch_serve_http.py and
# test_torch_async_frontdoor.py
LOOSE_SLO = ("--slo-ttft-ms", "60000", "--slo-tpot-ms", "60000",
             "--slo-queue-wait-ms", "60000")


@pytest.fixture(scope="module")
def fleet(export):
    fes = {pkg: _replica(pkg, export, *LOOSE_SLO) for pkg in ("jax", "port")}
    yield fes
    for fe in fes.values():
        fe.stop()


def test_router_over_both_packages_streams_identical(fleet):
    """A port router over a JAX and a port replica: every prompt streams
    the same greedy tokens through the router and from each replica
    directly, and the router's hash sends prompts to both."""
    urls = [fleet["jax"].url, fleet["port"].url]
    router = Router(urls, scrape_interval_s=30.0, enable_hedge=False,
                    prefix_len=4).start()
    try:
        prompts, shards = [], set()
        for i in range(64):
            p = [(5 * i + 3 * j + 1) % VOCAB for j in range(3 + i % 9)]
            prompts.append(p)
            shards.add(prefix_shard(p, 2, prefix_len=4))
            if len(prompts) >= 6 and shards == {0, 1}:
                break
        assert shards == {0, 1}
        for p in prompts:
            body = {"prompt": p, "max_new_tokens": 8}
            routed = collect_stream(router.url, body)
            direct = [collect_stream(u, body) for u in urls]
            for out in [routed] + direct:
                assert out["status"] == 200 and out["done"]
            assert routed["tokens"] == direct[0]["tokens"] \
                == direct[1]["tokens"]
            assert len(routed["tokens"]) == 8
        for u in urls:
            assert router._m_routed.labels(replica=u,
                                           kind="primary").value > 0
    finally:
        router.stop()


@pytest.fixture(scope="module", params=["fp", "int8"])
def tiered(request, export):
    """A JAX and a port replica, both `--phase prefill` (finished
    requests demote to the host tier) with a host tier in `mode`."""
    extra = ["--host-tier-bytes", str(1 << 20), "--phase", "prefill"]
    if request.param == "int8":
        extra.append("--kv-tier-int8")
    fes = {pkg: _replica(pkg, export, *extra) for pkg in ("jax", "port")}
    yield request.param, fes
    for fe in fes.values():
        fe.stop()


@pytest.mark.parametrize("src, dst", [("jax", "port"), ("port", "jax")])
def test_kvblocks_pull_across_packages(tiered, src, dst):
    """`dst` pulls the prompt's blocks from `src`'s /kvblocks (the
    router's x-ptpu-kv-source hint), revives them, and streams what it
    then streams warm from its own pool — which is `src`'s cold
    stream."""
    mode, fes = tiered
    source, target = fes[src], fes[dst]
    # a prompt of its own per direction: the target holds none of it
    prompt = [2 + len(src)] + SYSTEM[1:] + [21, 22, 23, 24]
    body = {"prompt": prompt, "max_new_tokens": 8}
    cold = collect_stream(source.url, body)
    assert cold["status"] == 200 and cold["done"]
    assert source.engine.host_tier.contains(tuple(prompt[:4]))
    obs = target.engine.obs
    pulled = collect_stream(target.url, body, headers={
        "x-ptpu-kv-source": source.url,
        "x-ptpu-kv-len": str(len(prompt))})
    assert pulled["status"] == 200 and pulled["done"]
    blocks = _counter_value(obs, "ptpu_kvxfer_blocks_total")
    assert blocks >= len(prompt) // 4
    assert _counter_value(obs, "ptpu_kvxfer_fallbacks_total") == 0
    assert _counter_value(obs, "ptpu_kv_tier_revived_blocks_total") > 0
    local_warm = collect_stream(target.url, body)
    assert pulled["tokens"] == local_warm["tokens"] == cold["tokens"]


def _engines(export, **kw):
    kw = dict(max_batch_size=4, block_size=4, num_blocks=16,
              host_tier_bytes=1 << 20, kv_compress_blocks=8, **kw)
    return (ServeEngine.from_saved_model(export, device="cpu",
                                         registry=MetricsRegistry(), **kw),
            JaxServeEngine.from_saved_model(export, registry=JaxRegistry(),
                                            **kw))


def test_directory_and_debug_state_equal_jax(export):
    """The same traffic on both packages' engines (fp pool, device int8
    pool and host tier all populated: the int8 pool is small enough to
    spill to the host): the same /kvprefixes rows, in order, and the
    same /debug snapshot, key for key."""
    port, ref = _engines(export)
    prompt = [7, 3, 7, 3, 11, 2, 5, 9]
    for eng in (port, ref):
        eng.generate([prompt], max_new_tokens=4)
        eng.generate([[50] * 8], max_new_tokens=8)
        for i in range(3):
            eng.generate([[30 + i] * 16], max_new_tokens=12)
        # one request left waiting and one running, so the summaries
        # have rows to compare
        eng.add_request(SYSTEM, max_new_tokens=6, deadline_ms=None)
        eng.add_request([9] * 5, max_new_tokens=6)
        eng.step()
    rows = port.kv_prefix_directory()
    assert {r["tier"] for r in rows} == {"device", "device_int8", "host"}
    assert rows == ref.kv_prefix_directory()
    got, want = port.debug_state(), ref.debug_state()
    assert got["running"] and set(got) == set(want)
    # request ids count per process in each package: compare the rows
    # with their ids taken out, and the ids by their offsets
    for state in (got, want):
        ids = [r.pop("req_id") for r in state["waiting"] + state["running"]]
        state["id_offsets"] = [i - min(ids) for i in ids]
    assert got == want


def test_bf16_blobs_are_pinned():
    """bf16 on the wire. fp mode: the port's blob carries the raw `|V2`
    payload, which JAX decodes to `|V2` arrays that `jnp.asarray`
    refuses (JAX's own behaviour for such npz payloads); a JAX bf16 blob
    decodes in the port to the same bits. int8 mode: the dtype rides by
    name, and either package's blob dequantizes to the same bf16 bits in
    the other."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 4, 2, 8))
                         .astype(np.float32)).to(torch.bfloat16)
    raw = [(to_host(x[0]), to_host(x[1]))]
    typed = [(np.asarray(jnp.asarray(x[0].float().numpy(), jnp.bfloat16)),
              np.asarray(jnp.asarray(x[1].float().numpy(), jnp.bfloat16)))]
    key = (1, 2, 3, 4)
    dg = prefix_digest(key)
    for int8 in (False, True):
        port = HostKVTier(1 << 20, int8=int8, registry=MetricsRegistry())
        ref = JaxHostKVTier(1 << 20, int8=int8, registry=JaxRegistry())
        port.put(key, raw)
        ref.put(key, typed)
        # port -> JAX
        k_in_jax, blobs, nbytes = jax_kvxfer.decode_entry(
            kvxfer.encode_tier_blob(port, dg), int8)
        assert k_in_jax == key
        in_jax = JaxHostKVTier(1 << 20, int8=int8, registry=JaxRegistry())
        assert in_jax.insert_encoded(key, blobs, nbytes)
        k = in_jax.get(key)[0][0]
        # JAX -> port
        k_in_port, blobs, nbytes = kvxfer.decode_entry(
            jax_kvxfer.encode_tier_blob(ref, dg), int8)
        assert k_in_port == key
        in_port = HostKVTier(1 << 20, int8=int8, registry=MetricsRegistry())
        assert in_port.insert_encoded(key, blobs, nbytes)
        back = in_port.get(key)[0][0]
        assert back.dtype.str == "|V2"
        assert np.array_equal(back.view(np.int16),
                              port.get(key)[0][0].view(np.int16))
        if int8:
            assert k.dtype.name == "bfloat16"
            assert np.array_equal(k.view(np.int16), back.view(np.int16))
        else:
            assert k.dtype.str == "|V2"
            assert np.array_equal(k.view(np.int16), raw[0][0].view(np.int16))
            with pytest.raises(TypeError):
                jnp.asarray(k)


def _seeded(seed, *extra):
    a = port_replica.build_parser().parse_args(
        ["--device", "cpu", "--port", "0", "--init-seed", str(seed),
         *extra])
    return port_replica.build_frontend(a)


def test_init_seed_replica_is_reproducible_and_serves():
    """No export: `--init-seed` draws the weights from a seeded
    torch.Generator — the same seed gives the same weights (another seed
    does not), the replica serves, and its byte tokenizer is JAX's for
    that seed (the weights are not JAX's: the packages' generators
    differ)."""
    a, b, c = _seeded(3), _seeded(3), _seeded(4)
    sa, sb, sc = (fe.engine.model.state_dict() for fe in (a, b, c))
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    assert a.tokenizer.encode("seeded") == \
        JaxByteTokenizer(VOCAB, seed=3).encode("seeded")
    a.start()
    try:
        out = collect_stream(a.url, {"prompt": "hello",
                                     "max_new_tokens": 5})
        assert out["status"] == 200 and out["done"]
        assert len(out["tokens"]) == 5
        assert out["tokens"] == b.engine.generate(
            [a.tokenizer.encode("hello")], max_new_tokens=5)[0]
    finally:
        a.stop()
