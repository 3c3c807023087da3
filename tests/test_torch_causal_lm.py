"""The port's CausalLM against the JAX CausalLM on the same weights.

Weights are made from a seed with numpy in the JAX `variables` layout
(paddle_tpu_torch.testing.causal_lm_tree), handed to JAX as they are and
to the port through `load_jax_params`. Logits are held at atol/rtol
1e-4: XLA:CPU and torch sum in different orders, and the differences
compound across layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.engine.engine import _fresh_cx
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.models.convert import jax_path
from paddle_tpu_torch.testing import causal_lm_tree

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB = 61
DIMS = dict(model_dim=16, num_heads=4, num_layers=2, ffn_dim=32)
MAX_LEN = 64
BS, TQ, MB = 4, 4, 8

VARIANTS = {
    "mha": dict(),
    "gqa": dict(num_kv_heads=2),
    "fused_qkv": dict(fused_qkv=True),
    "untied_head": dict(tie_embeddings=False),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def _pair(variant, seed=0):
    kw = VARIANTS[variant]
    tree = causal_lm_tree(seed, VOCAB, num_kv_heads=kw.get("num_kv_heads"),
                          fused_qkv=kw.get("fused_qkv", False),
                          tie_embeddings=kw.get("tie_embeddings", True),
                          embed_std=1.0, random_norms=True, **DIMS)
    jm = JaxCausalLM(VOCAB, dropout=0.0, max_len=MAX_LEN, **DIMS, **kw)
    tm = CausalLM(VOCAB, dropout=0.0, max_len=MAX_LEN, device="cpu",
                  **DIMS, **kw)
    load_jax_params(tm, tree)
    jvars = jax.tree_util.tree_map(jnp.asarray, tree)
    return jm, jvars, tm, tree


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tree_paths_match_jax_init(variant):
    """The numpy tree has exactly the paths and shapes JAX's own init
    produces, so load_jax_params reads real JAX checkpoints."""
    jm, _, _, tree = _pair(variant)
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    want = {k: np.shape(v) for k, v in _flat(jax.device_get(init)).items()}
    assert {k: np.shape(v) for k, v in _flat(tree).items()} == want


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_load_jax_params_round_trip(variant):
    _, _, tm, tree = _pair(variant)
    flat = _flat(tree)
    names = dict(tm.named_parameters())
    assert {jax_path(n) for n in names} == set(flat)
    for name, p in names.items():
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(),
                                      flat[jax_path(name)])


def test_load_jax_params_rejects_mismatches():
    _, _, tm, tree = _pair("mha")
    missing = causal_lm_tree(0, VOCAB, **DIMS)
    del missing["params"]["ln_f"]["bias"]
    with pytest.raises(KeyError, match="missing.*ln_f/bias"):
        load_jax_params(tm, missing)
    extra = causal_lm_tree(0, VOCAB, **DIMS)
    extra["params"]["head"] = {"weight": np.zeros((16, VOCAB), np.float32)}
    with pytest.raises(KeyError, match="extra.*head/weight"):
        load_jax_params(tm, extra)
    wrong = causal_lm_tree(0, VOCAB, **DIMS)
    wrong["params"]["embed"]["weight"] = np.zeros((VOCAB, 8), np.float32)
    with pytest.raises(ValueError, match="embed/weight"):
        load_jax_params(tm, wrong)
    with pytest.raises(ValueError, match="state"):
        load_jax_params(tm, dict(tree, state={"x": np.zeros(1)}))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_forward_matches_jax_apply(variant):
    jm, jvars, tm, _ = _pair(variant)
    toks = np.random.default_rng(1).integers(0, VOCAB, (3, 11))
    want = np.asarray(jm.apply(jvars, jnp.asarray(toks, jnp.int32)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _pack(rows, t_tiles):
    """Flat-pack rows of (token window, start position, block table)
    into ragged_step_paged operands padded to `t_tiles` tiles; the null
    row backs pad tiles and pad tokens scatter to scratch slot 0."""
    r = len(rows)
    t = t_tiles * TQ
    ops = {k: np.zeros(t, np.int32) for k in ("tokens", "positions",
                                              "slots")}
    ops.update(block_tables=np.zeros((r + 1, MB), np.int32),
               context_lens=np.ones(r + 1, np.int32),
               q_starts=np.zeros(r + 1, np.int32),
               tile_rows=np.full(t_tiles, r, np.int32),
               tile_offs=np.zeros(t_tiles, np.int32),
               last_idx=np.zeros(r, np.int32))
    cursor = 0
    for i, (window, start, table) in enumerate(rows):
        n = len(window)
        ops["tokens"][cursor:cursor + n] = window
        ops["positions"][cursor:cursor + n] = np.arange(start, start + n)
        ops["slots"][cursor:cursor + n] = [
            table[p // BS] * BS + p % BS for p in range(start, start + n)]
        ops["block_tables"][i, :len(table)] = table
        ops["context_lens"][i] = start + n
        ops["q_starts"][i] = start
        ops["last_idx"][i] = cursor + n - 1
        for k in range(-(-n // TQ)):
            ops["tile_rows"][cursor // TQ + k] = i
            ops["tile_offs"][cursor // TQ + k] = k * TQ
        cursor += -(-n // TQ) * TQ
    assert cursor <= t
    return ops


_ORDER = ("block_tables", "context_lens", "q_starts", "tile_rows",
          "tile_offs", "slots", "last_idx")


def _jax_step(jm, jvars, pools, ops):
    logits, pools = jm.ragged_step_paged(
        _fresh_cx(jvars), jnp.asarray(ops["tokens"]),
        jnp.asarray(ops["positions"]), pools,
        *[jnp.asarray(ops[k]) for k in _ORDER])
    return np.asarray(logits), pools


def _port_step(tm, pools, ops):
    with torch.inference_mode():
        return tm.ragged_step_paged(
            torch.from_numpy(ops["tokens"]),
            torch.from_numpy(ops["positions"]), pools,
            *[torch.from_numpy(ops[k]) for k in _ORDER]).numpy()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ragged_step_matches_jax_over_two_steps(variant):
    """Step 1 prefills two prompts; step 2 mixes a decode row, the
    second prompt's continuation chunk starting mid-block, and a fresh
    prompt, over the pools step 1 wrote. Logits and pool contents are
    held against JAX's ragged_step_paged after each step."""
    jm, jvars, tm, _ = _pair(variant)
    rng = np.random.default_rng(2)
    a, b, c = (rng.integers(0, VOCAB, n).tolist() for n in (10, 13, 5))
    attn = tm.blocks[0].attn
    shape = (12, BS, attn.num_kv_heads, attn.head_dim)
    jpools = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in tm.blocks]
    tpools = [(torch.zeros(shape), torch.zeros(shape)) for _ in tm.blocks]
    steps = [
        [(a, 0, [1, 2, 3]), (b[:7], 0, [4, 5])],
        [([(a[-1] + 1) % VOCAB], 10, [1, 2, 3]), (b[7:], 7, [4, 5, 6, 7]),
         (c, 0, [8, 9])],
    ]
    for rows in steps:
        ops = _pack(rows, t_tiles=10)
        want, jpools = _jax_step(jm, jvars, jpools, ops)
        got = _port_step(tm, tpools, ops)
        assert got.shape == (len(rows), VOCAB)
        np.testing.assert_allclose(got, want, **TOL)
        for (jk, jv), (tk, tv) in zip(jpools, tpools):
            # scratch block 0 takes the pad writes (arbitrary winner)
            np.testing.assert_allclose(tk[1:].numpy(), np.asarray(jk)[1:],
                                       **TOL)
            np.testing.assert_allclose(tv[1:].numpy(), np.asarray(jv)[1:],
                                       **TOL)


def test_ragged_step_matches_dense_forward():
    """One whole-prompt chunk per row through the serve step gives the
    dense forward's last-position logits (port against itself)."""
    _, _, tm, _ = _pair("gqa")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in (9, 4, 14)]
    ops = _pack([(p, 0, list(range(1 + 4 * i, 5 + 4 * i)))
                 for i, p in enumerate(prompts)], t_tiles=9)
    attn = tm.blocks[0].attn
    shape = (13, BS, attn.num_kv_heads, attn.head_dim)
    pools = [(torch.zeros(shape), torch.zeros(shape)) for _ in tm.blocks]
    got = _port_step(tm, pools, ops)
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            want = tm(torch.tensor([p]))[0, -1].numpy()
            np.testing.assert_allclose(got[i], want, **TOL)


def test_positions_are_clipped_like_jax():
    """A position past max_len reads the last encoding row (JAX clamps
    its gather; the port clips on purpose, transformer.py:792)."""
    jm, jvars, tm, _ = _pair("mha")
    ops = _pack([([3, 4], 0, [1])], t_tiles=2)
    ops["positions"][1] = MAX_LEN + 5
    attn = tm.blocks[0].attn
    shape = (2, BS, attn.num_kv_heads, attn.head_dim)
    jpools = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in tm.blocks]
    tpools = [(torch.zeros(shape), torch.zeros(shape)) for _ in tm.blocks]
    want, _ = _jax_step(jm, jvars, jpools, ops)
    np.testing.assert_allclose(_port_step(tm, tpools, ops), want, **TOL)


def test_model_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CausalLM(VOCAB, **DIMS)
