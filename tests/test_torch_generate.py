"""The port's dense KV-cache path against the JAX CausalLM's on the same
weights: `decode_step`, `prefill`, `prefill_paged` and `generate`
(mirrors of tests/test_causal_lm.py:56-102 and :167-208).

Weights are numpy-made in the JAX layout (paddle_tpu_torch.testing.
causal_lm_tree), handed to JAX as they are and to the port through
`load_jax_params`. On the CPU both sides take their plain attention
paths. Bars: logits and caches within 1e-5 (absolute and relative) in
float32; greedy token streams identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.engine.engine import _fresh_cx
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu.models.transformer import init_kv_caches as jax_init_caches
from paddle_tpu_torch.engine import ServeEngine
from paddle_tpu_torch.models import CausalLM, init_kv_caches, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.testing import causal_lm_tree

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 61
DIMS = dict(model_dim=16, num_heads=4, num_layers=2, ffn_dim=32)
MAX_LEN = 24
B, T = 2, 10

VARIANTS = {
    "mha": dict(),
    "gqa1": dict(num_kv_heads=1),
    "gqa2": dict(num_kv_heads=2),
    "fused_qkv": dict(fused_qkv=True),
    "untied_head": dict(tie_embeddings=False),
}


def _pair(variant="mha", seed=0, dtype=torch.float32):
    kw = VARIANTS[variant]
    tree = causal_lm_tree(seed, VOCAB, num_kv_heads=kw.get("num_kv_heads"),
                          fused_qkv=kw.get("fused_qkv", False),
                          tie_embeddings=kw.get("tie_embeddings", True),
                          **DIMS)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm = JaxCausalLM(VOCAB, dropout=0.0, max_len=MAX_LEN, dtype=jdt, **DIMS,
                     **kw)
    tm = CausalLM(VOCAB, dropout=0.0, max_len=MAX_LEN, dtype=dtype,
                  device="cpu", **DIMS, **kw)
    load_jax_params(tm, tree)
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm


def _tokens(seed, b=B, t=T):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_step_matches_jax_and_parallel(variant):
    """Token by token through a [B, T] cache: each step's logits against
    JAX's decode_step and against the port's own parallel forward, and
    the caches against JAX's after the last step."""
    jm, jvars, tm = _pair(variant, seed=1)
    tok = _tokens(2)
    with torch.no_grad():
        full = tm(torch.from_numpy(tok)).numpy()
    jc = jm.init_cache(B, max_len=T)
    tc = tm.init_cache(B, max_len=T)
    for i in range(T):
        want, jc = jm.decode_step(_fresh_cx(jvars), jnp.asarray(tok[:, i]),
                                  i, jc)
        with torch.no_grad():
            got, tc = tm.decode_step(torch.from_numpy(tok[:, i]), i, tc)
        _close(got, want)
        _close(got, full[:, i])
    for jl, tl in zip(jc, tc):
        _close(tl["k"], jl["k"])
        _close(tl["v"], jl["v"])


@pytest.mark.parametrize("variant", ["mha", "gqa1"])
def test_prefill_matches_jax(variant):
    """One parallel pass: last-position logits and the written caches
    (positions past the prompt stay zero)."""
    jm, jvars, tm = _pair(variant, seed=3)
    tok = _tokens(4, t=7)
    want, jc = jm.prefill(_fresh_cx(jvars), jnp.asarray(tok),
                          jm.init_cache(B, MAX_LEN))
    with torch.no_grad():
        got, tc = tm.prefill(torch.from_numpy(tok), tm.init_cache(B))
    _close(got, want)
    for jl, tl in zip(jc, tc):
        _close(tl["k"], jl["k"])
        _close(tl["v"], jl["v"])
        assert not tl["k"][:, 7:].any()


@pytest.mark.parametrize("variant", ["mha", "gqa2"])
def test_prefill_paged_matches_jax(variant):
    """Right-padded prompts: logits at last_pos and every layer's k/v."""
    jm, jvars, tm = _pair(variant, seed=5)
    tok = _tokens(6, b=3, t=9)
    last = np.array([8, 3, 5], np.int32)
    want, jkv = jm.prefill_paged(_fresh_cx(jvars), jnp.asarray(tok),
                                 jnp.asarray(last))
    with torch.no_grad():
        got, tkv = tm.prefill_paged(torch.from_numpy(tok),
                                    torch.from_numpy(last))
    _close(got, want)
    assert len(tkv) == DIMS["num_layers"]
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        assert tuple(tk.shape) == jk.shape
        _close(tk, jk)
        _close(tv, jv)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generate_greedy_matches_jax(variant):
    jm, jvars, tm = _pair(variant, seed=7)
    prompt = _tokens(8, t=4)
    want = jm.generate(jvars, jnp.asarray(prompt), num_steps=8)
    got = tm.generate(torch.from_numpy(prompt), num_steps=8)
    assert got.shape == (B, 12) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_greedy_is_stepwise_argmax():
    """The prompt is kept verbatim and each new token is the argmax of
    the parallel forward over the prefix (the port against itself)."""
    _, _, tm = _pair("gqa1", seed=9)
    prompt = torch.from_numpy(_tokens(10, t=4))
    out = tm.generate(prompt, num_steps=5)
    cur = prompt.long()
    with torch.no_grad():
        for _ in range(5):
            nxt = torch.argmax(tm(cur)[:, -1], dim=-1)
            cur = torch.cat([cur, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), cur.numpy())


def test_generate_greedy_matches_port_engine():
    """`generate`'s continuation equals the port's ServeEngine greedy
    stream on the same weights and prompts."""
    _, _, tm = _pair("gqa2", seed=11)
    prompts = _tokens(12, b=3, t=6)
    got = tm.generate(torch.from_numpy(prompts), num_steps=9)[:, 6:]
    engine = ServeEngine(tm, max_batch_size=4, block_size=4, num_blocks=32,
                         max_prefill_tokens=8, tile_q=4, device="cpu",
                         registry=MetricsRegistry())
    streams = engine.generate([p.tolist() for p in prompts],
                              max_new_tokens=9)
    assert got.tolist() == streams


def test_generate_sampled_errors_and_reproducibility():
    _, _, tm = _pair("mha", seed=13)
    prompt = torch.from_numpy(_tokens(14, t=3))

    def sample(seed, temperature=1.0):
        gen = torch.Generator().manual_seed(seed)
        return tm.generate(prompt, num_steps=6, generator=gen,
                           temperature=temperature)

    a, b = sample(7), sample(7)
    assert a.shape == (B, 9)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert ((a >= 0) & (a < VOCAB)).all()
    assert not all(torch.equal(a, sample(s)) for s in (1, 2, 3))
    # at a temperature near 0 the draw is the argmax
    np.testing.assert_array_equal(sample(5, 1e-4).numpy(),
                                  tm.generate(prompt, num_steps=6).numpy())
    with pytest.raises(ValueError, match="needs a generator"):
        tm.generate(prompt, num_steps=2, temperature=1.0)
    with pytest.raises(ValueError, match="exceeds"):
        tm.generate(prompt, num_steps=MAX_LEN)
    with pytest.raises(ValueError, match="non-empty"):
        tm.generate(prompt[:, :0], num_steps=2)
    np.testing.assert_array_equal(tm.generate(prompt, 0).numpy(),
                                  prompt.numpy())


def test_generate_restores_training_mode():
    _, _, tm = _pair("mha", seed=15)
    tm.train()
    tm.generate(torch.from_numpy(_tokens(16, t=3)), num_steps=2)
    assert tm.training


def test_init_kv_caches_layout_matches_jax():
    jm, _, tm = _pair("gqa2")
    want = jax_init_caches(jm.blocks, 3, 11)
    got = init_kv_caches(tm.blocks, 3, 11)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        for k in ("k", "v"):
            assert tuple(g[k].shape) == w[k].shape
            assert g[k].dtype == torch.float32 and not g[k].any()
    assert init_kv_caches(tm.blocks, 1, 2, dtype=torch.bfloat16)[0][
        "v"].dtype == torch.bfloat16


def test_decode_step_is_functional_and_clips_like_jax():
    """The input caches are left as they are (JAX returns new ones), and
    a position past the cache and the encoding clamps as JAX's
    dynamic_slice / dynamic_update_slice clamp."""
    jm, jvars, tm = _pair("mha", seed=17)
    tok = _tokens(18, t=1)[:, 0]
    tc = tm.init_cache(B, MAX_LEN)
    jc = jm.init_cache(B, MAX_LEN)
    with torch.no_grad():
        got, new = tm.decode_step(torch.from_numpy(tok), MAX_LEN + 3, tc)
    want, jnew = jm.decode_step(_fresh_cx(jvars), jnp.asarray(tok),
                                MAX_LEN + 3, jc)
    assert not tc[0]["k"].any()
    _close(got, want)
    _close(new[0]["k"], jnew[0]["k"])
    assert new[0]["k"][:, -1].any()


def test_bf16_model_decodes_from_bf16_cache():
    """A bf16 model's caches are bf16, and its decode logits stay within
    bf16 rounding of JAX's bf16 decode."""
    jm, jvars, tm = _pair("gqa1", seed=19, dtype=torch.bfloat16)
    assert tm.init_cache(B)[0]["k"].dtype == torch.bfloat16
    tok = _tokens(20, t=4)
    jc, tc = jm.init_cache(B, 4), tm.init_cache(B, 4)
    assert jc[0]["k"].dtype == jnp.bfloat16
    for i in range(4):
        want, jc = jm.decode_step(_fresh_cx(jvars), jnp.asarray(tok[:, i]),
                                  i, jc)
        with torch.no_grad():
            got, tc = tm.decode_step(torch.from_numpy(tok[:, i]), i, tc)
        assert tc[0]["k"].dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)
    out = tm.generate(torch.from_numpy(tok), num_steps=3)
    assert out.shape == (B, 7)
