"""The port's split paged prefill/decode path against the JAX package's.

- `paged_attention_reference` and `paged_prefill_attention` (the plain
  versions) match JAX's on the same numpy inputs, and the port's
  `paged_attention` wrapper — the plain version on CPU tensors — also
  matches JAX's Pallas `_paged_kernel` in interpret mode (f32, 1e-5).
- `CausalLM.prefill_chunk_paged` then `decode_step_paged` give the JAX
  model's logits on the same weights, and the pools they write in place
  equal the pools JAX returns.
The CUDA kernel itself runs only on the card:
tests/test_torch_kernels_gpu.py holds it against this plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.module import Context, _CtxCore
from paddle_tpu.kernels import paged_attention as jax_paged
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.testing import PAGED_ARGS, causal_lm_tree, paged_case

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = {
    # name: (context_lens, H, Hkv, D, block_size) — test_paged_attention's
    "single_token": ([1, 1, 1], 4, 4, 8, 4),
    "block_boundaries": ([4, 8, 16], 4, 4, 8, 4),
    "mixed_depths": ([1, 4, 7, 13], 4, 4, 8, 4),
    "gqa": ([3, 9], 8, 2, 16, 4),
    "mqa": ([5, 12], 4, 1, 8, 8),
}


def _case(name, seed=0):
    lens, h, hkv, d, bs = CASES[name]
    return paged_case(lens, h, hkv, d, bs, seed=seed)


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_decode_matches_jax(name):
    case = _case(name)
    ts = [torch.from_numpy(case[k]) for k in PAGED_ARGS]
    js = [jnp.asarray(case[k]) for k in PAGED_ARGS]
    want_ref = np.asarray(jax_paged.paged_attention_reference(*js))
    want_ker = np.asarray(jax_paged.paged_attention(
        *js, use_kernel=True, interpret=True))
    before = paged.paged_attention.launches
    got = paged.paged_attention(*ts, check_block_ids=True).numpy()
    assert paged.paged_attention.launches == before     # plain on CPU
    np.testing.assert_allclose(
        paged.paged_attention_reference(*ts).numpy(), want_ref, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_ker, **TOL)


def test_paged_decode_scale_and_checks():
    case = _case("gqa")
    ts = [torch.from_numpy(case[k]) for k in PAGED_ARGS]
    js = [jnp.asarray(case[k]) for k in PAGED_ARGS]
    np.testing.assert_allclose(
        paged.paged_attention(*ts, scale=0.3).numpy(),
        np.asarray(jax_paged.paged_attention_reference(*js, scale=0.3)),
        **TOL)
    oob = list(ts)
    oob[3] = ts[3].clone()
    oob[3][0, 0] = ts[1].shape[0]
    with pytest.raises(ValueError, match="outside the pools"):
        paged.paged_attention(*oob, check_block_ids=True)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        paged.paged_attention(ts[0][:, :3].contiguous(), *ts[1:])


def _edge_case(edge):
    """Decode rows at the contract's edges (H 4 over Hkv 2, D 8, blocks
    of 4): "context_0", rows that see no position between rows that do;
    "past_table", contexts past the table's MB * BS = 16 positions (the
    table cut to its first 4 blocks) beside one inside it."""
    if edge == "context_0":
        return paged_case([0, 5, 0, 13], 4, 2, 8, 4, seed=3)
    case = paged_case([9, 30, 17], 4, 2, 8, 4, seed=4)
    case["block_tables"] = np.ascontiguousarray(case["block_tables"][:, :4])
    return case


def test_pallas_decode_kernel_gives_zeros_at_context_0():
    """JAX's Pallas `_paged_kernel` (interpret mode) reads no block of a
    row at context 0 and writes acc / max(l, 1e-30) = 0 exactly, what the
    port's CUDA kernel copies; the other rows are the reference's."""
    case = _edge_case("context_0")
    js = [jnp.asarray(case[k]) for k in PAGED_ARGS]
    got = np.asarray(jax_paged.paged_attention(*js, use_kernel=True,
                                               interpret=True))
    assert (got[[0, 2]] == 0).all()
    np.testing.assert_allclose(
        got[[1, 3]],
        np.asarray(jax_paged.paged_attention_reference(*js))[[1, 3]], **TOL)


@pytest.mark.parametrize("edge", ["context_0", "past_table"])
def test_plain_decode_matches_jax_at_the_edges(edge):
    """The port's plain version gives JAX's reference at context 0 (every
    position masked: the reference's softmax over the masked scores, not
    the kernels' zeros) and at contexts past the table (its MB * BS
    positions, as the Pallas kernel sees them too)."""
    case = _edge_case(edge)
    ts = [torch.from_numpy(case[k]) for k in PAGED_ARGS]
    js = [jnp.asarray(case[k]) for k in PAGED_ARGS]
    got = paged.paged_attention(*ts, check_block_ids=True).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_paged.paged_attention_reference(*js)), **TOL)
    if edge == "past_table":
        np.testing.assert_allclose(got, np.asarray(jax_paged.paged_attention(
            *js, use_kernel=True, interpret=True)), **TOL)


@pytest.mark.parametrize("name", ["mixed_depths", "gqa"])
def test_paged_prefill_matches_jax(name):
    """A chunk of C queries per row at absolute positions ending at the
    row's context; pad rows at position 0 with ctx 1."""
    case = _case(name)
    lens = case["context_lens"]
    c = 3
    pos = np.stack([np.maximum(np.arange(n - c, n), 0) for n in lens])
    rng = np.random.default_rng(5)
    q = rng.standard_normal((len(lens), c) + case["q"].shape[1:],
                            np.float32)
    args = (q, case["k_pool"], case["v_pool"], case["block_tables"],
            lens, pos.astype(np.int32))
    got = paged.paged_prefill_attention(*[torch.from_numpy(a)
                                          for a in args]).numpy()
    want = np.asarray(jax_paged.paged_prefill_attention(
        *[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(got, want, **TOL)


# -- the split path through the model -----------------------------------

VOCAB = 61
DIMS = dict(model_dim=32, num_heads=4, num_layers=2, ffn_dim=64,
            num_kv_heads=2)
BS, MB, NB = 4, 6, 40


def _cx(variables):
    return Context(_CtxCore(mode="apply", variables=variables, mutated={},
                            rng=None, rng_count=0, training=False))


@pytest.fixture(scope="module")
def models():
    tree = causal_lm_tree(2, VOCAB, **DIMS, random_norms=True)
    jm = JaxCausalLM(VOCAB, dropout=0.0, max_len=32, **DIMS)
    tm = CausalLM(VOCAB, dropout=0.0, max_len=32, device="cpu", **DIMS)
    load_jax_params(tm, tree)
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm


def _split_path_operands(prompts):
    """Block tables for rows whose blocks are handed out in order from
    block 1 (room for decode tokens after the prompt); the chunk covers
    each prompt, right-padded to C with pads at scratch slot 0."""
    b = len(prompts)
    c = max(len(p) for p in prompts)
    tables = np.zeros((b, MB), np.int32)
    nxt = 1
    for i in range(b):
        tables[i] = np.arange(nxt, nxt + MB)
        nxt += MB
    tokens = np.zeros((b, c), np.int32)
    slots = np.zeros((b, c), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        slots[i, :len(p)] = [tables[i, j // BS] * BS + j % BS
                             for j in range(len(p))]
    return tables, tokens, slots.reshape(-1)


def test_decode_after_prefill_matches_jax_model(models):
    """prefill_chunk_paged over whole prompts, then three
    decode_step_paged steps feeding back the JAX model's greedy tokens:
    logits equal the JAX model's at every step (1e-4 on logits of
    magnitude ~10), and the in-place pools equal JAX's returned pools."""
    jm, jvars, tm = models
    prompts = [[5, 9, 2, 11, 7], [3, 1, 4, 1, 5, 9, 2, 6, 5], [8, 8]]
    tables, tokens, slots = _split_path_operands(prompts)
    lens = np.array([len(p) for p in prompts], np.int32)
    start = np.zeros(len(prompts), np.int32)
    hkv, hd = DIMS["num_kv_heads"], DIMS["model_dim"] // DIMS["num_heads"]
    shape = (NB, BS, hkv, hd)
    tpools = [(torch.zeros(shape), torch.zeros(shape))
              for _ in range(DIMS["num_layers"])]
    jpools = [(jnp.zeros(shape), jnp.zeros(shape))
              for _ in range(DIMS["num_layers"])]
    t = torch.from_numpy
    with torch.inference_mode():
        got = tm.prefill_chunk_paged(t(tokens), t(start), tpools, t(tables),
                                     t(lens), t(slots), t(lens - 1))
    want, jpools = jm.prefill_chunk_paged(
        _cx(jvars), jnp.asarray(tokens), jnp.asarray(start), jpools,
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(slots),
        jnp.asarray(lens - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    before = paged.paged_attention.launches
    for _ in range(3):
        tok = np.asarray(want).argmax(-1).astype(np.int32)
        pos = lens.copy()
        lens = lens + 1
        dslots = np.array([tables[i, p // BS] * BS + p % BS
                           for i, p in enumerate(pos)], np.int32)
        with torch.inference_mode():
            got = tm.decode_step_paged(t(tok), t(pos), tpools, t(tables),
                                       t(lens), t(dslots))
        want, jpools = jm.decode_step_paged(
            _cx(jvars), jnp.asarray(tok), jnp.asarray(pos), jpools,
            jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(dslots))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    assert paged.paged_attention.launches == before     # plain on CPU
    for (tk, tv), (jk, jv) in zip(tpools, jpools):      # block 0 = scratch
        np.testing.assert_allclose(tk[1:].numpy(), np.asarray(jk)[1:],
                                   **TOL)
        np.testing.assert_allclose(tv[1:].numpy(), np.asarray(jv)[1:],
                                   **TOL)


def test_split_path_matches_dense_forward(models):
    """The split path's logits at each decoded position equal the dense
    forward over the whole sequence (the oracle chip_smoke.py holds the
    card to)."""
    _, _, tm = models
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
    tables, tokens, slots = _split_path_operands([prompt])
    hkv, hd = DIMS["num_kv_heads"], DIMS["model_dim"] // DIMS["num_heads"]
    pools = [(torch.zeros(NB, BS, hkv, hd), torch.zeros(NB, BS, hkv, hd))
             for _ in range(DIMS["num_layers"])]
    t = torch.from_numpy
    n = len(prompt)
    with torch.inference_mode():
        logits = tm.prefill_chunk_paged(
            t(tokens), torch.zeros(1, dtype=torch.int32), pools, t(tables),
            torch.tensor([n], dtype=torch.int32), t(slots),
            torch.tensor([n - 1]))
        seq = list(prompt)
        for _ in range(2):
            seq.append(int(logits[0].argmax()))
            p = len(seq) - 1
            slot = int(tables[0, p // BS]) * BS + p % BS
            logits = tm.decode_step_paged(
                torch.tensor([seq[-1]]), torch.tensor([p]), pools,
                t(tables), torch.tensor([p + 1], dtype=torch.int32),
                torch.tensor([slot]))
            dense = tm(torch.tensor([seq]))[0, -1]
            np.testing.assert_allclose(logits[0].numpy(), dense.numpy(),
                                       atol=1e-4, rtol=1e-4)
