"""The encoder models of the port (`Transformer`, `BertEncoder`), its
`beam_search` and the module helpers, against the JAX package.

- The non-slow tests of tests/test_transformer.py on the port (its slow
  convergence test is left out), test_models_nlp.py's
  `test_bert_encoder_mlm` and test_fused_ce.py's
  `test_transformer_fused_ce_path_matches_head_logits`.
- Cross-package checks on the same numpy-made weights (`transformer_tree`,
  `bert_tree`, loaded by path), all on the CPU through the plain
  attention: logits with and without `src_lengths`, fused and unfused,
  tied and untied; `decode_step`; `beam_search` tokens and scores with
  `early_exit` off and on; BERT's hidden states, MLM logits and
  gradients against `jax.grad`; 5 Adam steps of both `Trainer`s. Bars:
  1e-5 (values of order 1, float32 sums in other orders).
- The trees' paths and shapes pinned to `model.init`'s (`jax.eval_shape`,
  nothing compiled), and the port's own invariants: incremental decoding
  equals teacher-forced decoding, `decode_step_paged` equals
  `decode_step`.

JAX runs each model function as one jitted program (eager dispatch would
compile every op).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.executor import Trainer as JaxTrainer
from paddle_tpu.core.executor import TrainState as JaxTrainState
from paddle_tpu.core.module import Context, _CtxCore
from paddle_tpu.core.module import named_params as jax_named_params
from paddle_tpu.core.module import param_count as jax_param_count
from paddle_tpu.models.transformer import BertEncoder as JaxBert
from paddle_tpu.models.transformer import Transformer as JaxTransformer
from paddle_tpu.ops import functional as JF
from paddle_tpu.ops.beam_search import beam_search as jax_beam_search
from paddle_tpu.ops.beam_search import tile_beams as jax_tile_beams
from paddle_tpu.optim.optimizer import Adam as JaxAdam
from paddle_tpu_torch.core import (ModuleError, Sequential, Trainer,
                                   named_params, param_count)
from paddle_tpu_torch.kernels.attention import reference_attention
from paddle_tpu_torch.models import (BertEncoder, Transformer,
                                     load_jax_params, to_jax_params)
from paddle_tpu_torch.ops import (beam_search, linear_cross_entropy,
                                  softmax_with_cross_entropy, tile_beams)
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.testing import bert_tree, transformer_tree
from paddle_tpu_torch.utils.tree import flatten_with_keys

SRC_V, TRG_V, MAX_LEN = 31, 37, 16
DIMS = dict(model_dim=32, num_heads=4, num_layers=2, ffn_dim=64)
BERT = dict(vocab=50, model_dim=32, num_heads=2, num_layers=2, ffn_dim=64,
            max_len=16)
# (fused_qkv, tie_embeddings); a tied model takes one vocabulary
VARIANTS = {"unfused": (False, False), "fused": (True, False),
            "unfused_tied": (False, True), "fused_tied": (True, True)}


def _vocabs(tied):
    return (TRG_V, TRG_V) if tied else (SRC_V, TRG_V)


def _tree(variant, seed=0):
    fused, tied = VARIANTS[variant]
    return transformer_tree(seed, *_vocabs(tied), **DIMS, fused_qkv=fused,
                            tie_embeddings=tied, random_norms=True)


def _port(variant, tree=None):
    fused, tied = VARIANTS[variant]
    m = Transformer(*_vocabs(tied), **DIMS, dropout=0.0, max_len=MAX_LEN,
                    fused_qkv=fused, tie_embeddings=tied, device="cpu")
    return load_jax_params(m, tree if tree is not None else _tree(variant))


def _jax(variant):
    fused, tied = VARIANTS[variant]
    return JaxTransformer(*_vocabs(tied), **DIMS, dropout=0.0,
                          max_len=MAX_LEN, fused_qkv=fused,
                          tie_embeddings=tied)


def _jvars(tree):
    return jax.tree.map(jnp.asarray, tree)


def _cx(variables):
    return Context(_CtxCore(mode="apply", variables=variables, mutated={},
                            rng=None, rng_count=0, training=False))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _src_trg(seed, b=2, ts=9, tt=7, tied=False):
    rs = np.random.RandomState(seed)
    src_v, trg_v = _vocabs(tied)
    return (rs.randint(2, src_v, (b, ts)).astype(np.int32),
            rs.randint(2, trg_v, (b, tt)).astype(np.int32))


def _close(got, want, rel=1e-5, floor=0.0, top=None):
    """Within `rel` of the array's largest magnitude (and of itself),
    plus `floor` times `top`."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * scale + floor * (top or 0.0))


# -- the tests of tests/test_transformer.py on the port ----------------------

def test_forward_shapes_and_masking(rng):
    model = _port("unfused")
    src = _t(rng.randint(0, SRC_V, (2, 9)))
    trg = _t(rng.randint(0, TRG_V, (2, 7)))
    src_len = torch.tensor([9, 4])
    with torch.no_grad():
        logits = model(src, trg, src_len)
        assert logits.shape == (2, 7, TRG_V)
        # changing masked src positions can't change logits
        src2 = src.clone()
        src2[1, 5:] = 7                      # beyond length 4
        logits2 = model(src2, trg, src_len)
    np.testing.assert_allclose(logits[1].numpy(), logits2[1].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_causality(rng):
    """Future target tokens must not affect earlier positions."""
    model = _port("unfused")
    src = _t(rng.randint(0, SRC_V, (1, 5)))
    trg = rng.randint(0, TRG_V, (1, 8))
    with torch.no_grad():
        base = model(src, _t(trg))
        trg2 = trg.copy()
        trg2[0, 5] = (trg2[0, 5] + 3) % TRG_V
        out = model(src, _t(trg2))
    np.testing.assert_allclose(base[0, :5].numpy(), out[0, :5].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(base[0, 5:].numpy(), out[0, 5:].numpy())


@pytest.mark.parametrize("variant", ["unfused", "fused_tied"])
def test_incremental_decode_matches_teacher_forced(variant, rng):
    """decode_step with the KV cache reproduces the parallel decoder, the
    contract that makes beam search trustworthy (within 1e-5 here; JAX's
    own test holds 1e-3 / 1e-4)."""
    model = _port(variant)
    tied = VARIANTS[variant][1]
    src = _t(rng.randint(0, _vocabs(tied)[0], (2, 6)))
    trg = _t(rng.randint(1, TRG_V, (2, 5)))
    src_len = torch.tensor([6, 4])
    with torch.no_grad():
        full = model(src, trg, src_len)                  # [B, 5, V]
        memory, src_mask = model.encode(src, src_len)
        caches = model.init_cache(2, max_len=8)
        outs = []
        for t in range(5):
            logits, caches = model.decode_step(trg[:, t], t, memory, caches,
                                               src_mask)
            outs.append(logits)
    _close(torch.stack(outs, 1).numpy(), full.numpy())


def test_beam_search_greedy_consistency():
    """With beam_size=1 and a peaked distribution, beam search returns
    the argmax chain."""
    vocab = 11
    target = torch.tensor([3, 5, 2, 1, 1])      # 1 == eos from step 3 on

    def decode_fn(tokens, pos, state):
        logits = torch.full((tokens.shape[0], vocab), -10.0)
        logits[:, target[pos]] = 10.0
        return logits, state

    res = beam_search(decode_fn, {"dummy": torch.zeros((2, 1))}, batch=2,
                      beam_size=1, max_len=5, bos_id=0, eos_id=1,
                      vocab_size=vocab)
    np.testing.assert_array_equal(res.tokens[:, 0].numpy()[0],
                                  target.numpy())
    assert int(res.lengths[0, 0]) == 4          # up to and incl. eos


def test_beam_search_prefers_higher_prob_path():
    """Beam recovers the globally better path that greedy misses: step 0's
    token 2 is slightly worse, but leads to a much better step 1."""
    vocab, eos = 4, 3

    def decode_fn(tokens, pos, state):
        b = tokens.shape[0]
        if pos == 0:
            row = torch.tensor([-10.0, np.log(0.6), np.log(0.4), -10.0])
            return row[None].repeat(b, 1), state
        good = torch.tensor([-10.0, -10.0, -10.0, 0.0])
        meh = torch.log(torch.tensor([0.3, 0.3, 0.3, 0.1]))
        return torch.where((tokens == 2)[:, None], good[None],
                           meh[None]), state

    res = beam_search(decode_fn, {"s": torch.zeros((2, 1))}, batch=1,
                      beam_size=2, max_len=3, bos_id=0, eos_id=eos,
                      vocab_size=vocab)
    # best path: 2 then eos (0.4 * 1.0) beats 1 then the best 0.3 (0.18)
    assert int(res.tokens[0, 0, 0]) == 2
    assert int(res.tokens[0, 0, 1]) == eos


def _beam_setup(model, src, src_len, k):
    memory, src_mask = model.encode(src, src_len)
    memory_t, mask_t = tile_beams(memory, k), tile_beams(src_mask, k)

    def decode_fn(tokens, pos, caches):
        return model.decode_step(tokens, pos, memory_t, caches, mask_t)
    return decode_fn


def test_transformer_beam_decode_end_to_end(rng):
    """encode -> tiled caches -> beam_search over decode_step."""
    model = _port("unfused")
    src = _t(rng.randint(2, SRC_V, (2, 6)))
    src_len = torch.tensor([6, 5])
    k = 3
    with torch.no_grad():
        decode_fn = _beam_setup(model, src, src_len, k)
        res = beam_search(decode_fn, model.init_cache(2 * k, max_len=8),
                          batch=2, beam_size=k, max_len=8, bos_id=1,
                          eos_id=0, vocab_size=TRG_V, length_penalty=0.6)
    assert res.tokens.shape == (2, k, 8)
    assert res.scores.shape == (2, k)
    assert (np.diff(res.scores.numpy(), axis=1) <= 1e-5).all()


def test_reference_attention_softmax_property(rng):
    q = torch.from_numpy(rng.randn(2, 4, 2, 8).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 6, 2, 8).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 6, 2, 8).astype(np.float32))
    out = reference_attention(q, k, v)
    assert out.shape == (2, 4, 2, 8)
    # a convex combination: bounded by v's extremes
    assert float(out.max()) <= float(v.max()) + 1e-4
    assert float(out.min()) >= float(v.min()) - 1e-4


def _pack(attn, names, h=4, hd=8):
    """Head-major packing of unfused projections: columns [head, role,
    head_dim]."""
    out = {}
    for part in ("weight", "bias"):
        per = [attn[n][part].reshape(attn[n][part].shape[:-1] + (h, hd))
               for n in names]
        stacked = np.stack(per, axis=-2)
        out[part] = stacked.reshape(stacked.shape[:-3]
                                    + (h * len(names) * hd,))
    return out


def _stitch(tree):
    """The unfused tree's weights in the fused layout."""
    pf = {}
    for k, v in tree["params"].items():
        if k.startswith("enc_layers_"):
            pf[k] = dict(v, attn={
                "qkv": _pack(v["attn"], ("q_proj", "k_proj", "v_proj")),
                "out_proj": v["attn"]["out_proj"]})
        elif k.startswith("dec_layers_"):
            sa, ca = v["self_attn"], v["cross_attn"]
            pf[k] = dict(v, self_attn={
                "qkv": _pack(sa, ("q_proj", "k_proj", "v_proj")),
                "out_proj": sa["out_proj"]}, cross_attn={
                "q_proj": ca["q_proj"],
                "kv": _pack(ca, ("k_proj", "v_proj")),
                "out_proj": ca["out_proj"]})
        else:
            pf[k] = v
    return {"params": pf}


def test_fused_qkv_matches_unfused(rng):
    """Packed projections are a pure re-layout: the unfused weights
    stitched into the packed parameters give the unfused logits."""
    tree = _tree("unfused")
    base, fused = _port("unfused", tree), _port("fused", _stitch(tree))
    src = _t(rng.randint(0, SRC_V, (2, 9)))
    trg = _t(rng.randint(0, TRG_V, (2, 7)))
    with torch.no_grad():
        np.testing.assert_allclose(fused(src, trg).numpy(),
                                   base(src, trg).numpy(),
                                   rtol=1e-5, atol=1e-5)


# -- test_models_nlp.py::test_bert_encoder_mlm and test_fused_ce.py ----------

def test_bert_encoder_mlm(rng):
    """Hidden states, the tied MLM head, gradients flow, and a masked
    position's logits depend on the other tokens (bidirectional)."""
    tree = bert_tree(0, **BERT)
    m = load_jax_params(BertEncoder(**BERT, dropout=0.0, device="cpu"), tree)
    toks = _t(rng.randint(0, 50, (2, 8)))
    pos = _t(np.sort(rng.rand(2, 8).argsort(1)[:, :2], 1))
    assert m(toks).shape == (2, 8, 32)
    logits = m(toks, pos)
    assert logits.shape == (2, 2, 50)
    names = [n for n, _ in named_params(m)]
    assert not any("head" in n for n in names) and "weight" not in names
    logits.sum().backward()
    assert all(p.grad is not None for p in m.parameters())
    with torch.no_grad():
        m.embed.weight += 0.1                   # the head really is tied
        assert not torch.allclose(m(toks, pos), logits)
        m.embed.weight -= 0.1
        toks2 = toks.clone()
        toks2[0, 5] = (toks2[0, 5] + 1) % 50
        assert int(pos[0, 0]) != 5 and int(pos[0, 1]) != 5
        assert not torch.allclose(m(toks2, pos)[0], m(toks, pos)[0])


def test_bert_refuses_a_root_level_weight():
    """A tree from before JAX's Embedding.attend scoping fix (a root-level
    `weight`, the untied MLM head it trained) is refused with JAX's
    ModuleError, not the loader's KeyError."""
    tree = bert_tree(0, **BERT)
    tree["params"]["weight"] = np.zeros((50, 32), np.float32)
    m = BertEncoder(**BERT, dropout=0.0, device="cpu")
    with pytest.raises(ModuleError, match="scoping fix"):
        load_jax_params(m, tree)


def test_transformer_fused_ce_path_matches_head_logits():
    """return_hidden + linear_cross_entropy == full logits +
    softmax_with_cross_entropy on the same weights."""
    rs = np.random.RandomState(5)
    v, b, t = 97, 2, 6
    tree = transformer_tree(0, v, v, 16, 2, 1, 32)
    model = load_jax_params(Transformer(v, v, 16, 2, 1, 32, dropout=0.0,
                                        max_len=t + 1, device="cpu"), tree)
    src = _t(rs.randint(0, v, (b, t)))
    trg = _t(rs.randint(0, v, (b, t)))
    out = _t(rs.randint(0, v, (b, t)))
    with torch.no_grad():
        want = softmax_with_cross_entropy(model(src, trg).float(), out)
        hid = model(src, trg, return_hidden=True)
        got = linear_cross_entropy(hid, model.head.weight, out,
                                   model.head.bias, chunk=64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


# -- cross-package: trees, logits, decoding, beam search ---------------------

def _shapes(tree):
    return {k: tuple(v.shape) for k, v in flatten_with_keys(tree)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_transformer_tree_pins_jax_init(variant):
    src, trg = _src_trg(0, tied=VARIANTS[variant][1])
    want = jax.eval_shape(lambda: _jax(variant).init(0, jnp.asarray(src),
                                                     jnp.asarray(trg)))
    assert _shapes(_tree(variant)) == _shapes(
        jax.tree.map(lambda s: np.zeros(s.shape), dict(want)))
    # the port's own tree, by path and shape, and a round trip
    model = _port(variant)
    assert _shapes(to_jax_params(model)) == _shapes(_tree(variant))
    back = to_jax_params(model)
    for (k, a), (_, b) in zip(flatten_with_keys(back),
                              flatten_with_keys(_tree(variant))):
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
def test_bert_tree_pins_jax_init(fused):
    jm = JaxBert(**BERT, dropout=0.0, fused_qkv=fused)
    toks = jnp.zeros((2, 8), jnp.int32)
    want = jax.eval_shape(lambda: jm.init(0, toks,
                                          jnp.zeros((2, 2), jnp.int32)))
    tree = bert_tree(0, **BERT, fused_qkv=fused)
    assert _shapes(tree) == _shapes(
        jax.tree.map(lambda s: np.zeros(s.shape), dict(want)))
    m = load_jax_params(BertEncoder(**BERT, dropout=0.0, fused_qkv=fused,
                                    device="cpu"), tree)
    for (k, a), (_, b) in zip(flatten_with_keys(to_jax_params(m)),
                              flatten_with_keys(tree)):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_module_helpers_match_jax():
    """param_count, named_params (JAX's names and order) and Sequential."""
    tree = _tree("fused_tied")
    model = _port("fused_tied", tree)
    jvars = _jvars(tree)
    assert param_count(model) == jax_param_count(jvars) == param_count(tree)
    want = jax_named_params(jvars)
    got = named_params(model)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, p), (_, w) in zip(got, want):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(w),
                                      err_msg=n)
    seq = Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU(),
                     torch.nn.Linear(4, 2))
    x = torch.randn(5, 3)
    np.testing.assert_array_equal(
        seq(x, training=True).detach().numpy(),
        seq.layers[2](torch.relu(seq.layers[0](x))).detach().numpy())
    assert [n for n, _ in named_params(seq)] == [
        "layers_0/bias", "layers_0/weight", "layers_2/bias",
        "layers_2/weight"]


LOGIT_CASES = [("unfused", True), ("unfused", False), ("fused_tied", True),
               ("fused_tied", False)]


@pytest.mark.parametrize("variant,with_lengths", LOGIT_CASES)
def test_transformer_logits_match_jax(variant, with_lengths):
    tied = VARIANTS[variant][1]
    src, trg = _src_trg(3, tied=tied)
    lens = np.array([9, 5], np.int32) if with_lengths else None
    jm = _jax(variant)
    want = jax.jit(lambda v, s, t, l: jm.apply(v, s, t, l))(
        _jvars(_tree(variant)), src, trg, lens)
    with torch.no_grad():
        got = _port(variant)(_t(src), _t(trg),
                             None if lens is None else _t(lens))
    _close(got.numpy(), np.asarray(want))


def _jax_decode(jm, variables, src, lens, trg, tmax):
    """JAX's encode, then decode_step over trg's positions (one jitted
    program): logits [B, T, V]."""
    def run(v, src, lens, trg):
        cx = _cx(v)
        memory, src_mask = jm.encode(cx, src, lens)
        caches = jm.init_cache(src.shape[0], max_len=tmax)
        outs = []
        for t in range(trg.shape[1]):
            logits, caches = jm.decode_step(cx, trg[:, t], t, memory,
                                            caches, src_mask)
            outs.append(logits)
        return jnp.stack(outs, 1)
    return np.asarray(jax.jit(run)(variables, src, lens, trg))


def test_decode_step_matches_jax_and_paged_matches_dense():
    """decode_step's logits against JAX's, and decode_step_paged (the
    decoder's self-attention k/v in paged pools with shuffled block
    tables; block size 4) against decode_step on the same tokens."""
    variant = "fused_tied"
    tied = VARIANTS[variant][1]
    src, trg = _src_trg(4, b=3, ts=7, tt=5, tied=tied)
    lens = np.array([7, 3, 5], np.int32)
    want = _jax_decode(_jax(variant), _jvars(_tree(variant)), src, lens, trg,
                       tmax=8)
    model = _port(variant)
    b, steps, bs = 3, trg.shape[1], 4
    with torch.no_grad():
        memory, src_mask = model.encode(_t(src), _t(lens))
        caches = model.init_cache(b, max_len=8)
        dense = []
        for t in range(steps):
            logits, caches = model.decode_step(_t(trg[:, t]), t, memory,
                                               caches, src_mask)
            dense.append(logits)
        dense = torch.stack(dense, 1)
        # paged: each sequence's blocks drawn from a shuffled pool
        mb = -(-steps // bs)
        ids = np.random.RandomState(0).permutation(np.arange(1, 1 + b * mb))
        tables = torch.from_numpy(ids.reshape(b, mb).astype(np.int32))
        attn = model.dec_layers[0].self_attn
        pools = [(torch.zeros(1 + b * mb, bs, attn.num_kv_heads,
                              attn.head_dim),
                  torch.zeros(1 + b * mb, bs, attn.num_kv_heads,
                              attn.head_dim)) for _ in model.dec_layers]
        paged = []
        for t in range(steps):
            pos = torch.full((b,), t, dtype=torch.int32)
            slots = tables[:, t // bs].long() * bs + t % bs
            paged.append(model.decode_step_paged(
                _t(trg[:, t]), pos, memory, pools, tables, pos + 1, slots,
                src_mask))
        paged = torch.stack(paged, 1)
    _close(dense.numpy(), want)
    _close(paged.numpy(), dense.numpy())


@pytest.mark.parametrize("early_exit", [False, True])
def test_beam_search_matches_jax(early_exit):
    """beam_search over decode_step on the same weights: JAX's tokens and
    lengths, its scores within 1e-5."""
    variant, k, max_len = "unfused", 3, 8
    src, _ = _src_trg(6, b=2, ts=6)
    lens = np.array([6, 4], np.int32)
    jm, tree = _jax(variant), _tree(variant)

    def run(v, src, lens):
        cx = _cx(v)
        memory, src_mask = jm.encode(cx, src, lens)
        memory_t = jax_tile_beams(memory, k)
        mask_t = jax_tile_beams(src_mask, k)

        def decode_fn(tokens, pos, caches):
            return jm.decode_step(cx, tokens, pos, memory_t, caches, mask_t)
        return jax_beam_search(decode_fn, jm.init_cache(2 * k, max_len),
                               batch=2, beam_size=k, max_len=max_len,
                               bos_id=1, eos_id=0, vocab_size=TRG_V,
                               length_penalty=0.6, early_exit=early_exit)
    want = jax.jit(run)(_jvars(tree), src, lens)
    model = _port(variant, tree)
    with torch.no_grad():
        got = beam_search(_beam_setup(model, _t(src), _t(lens), k),
                          model.init_cache(2 * k, max_len), batch=2,
                          beam_size=k, max_len=max_len, bos_id=1, eos_id=0,
                          vocab_size=TRG_V, length_penalty=0.6,
                          early_exit=early_exit)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)


def test_early_exit_equals_the_full_run():
    """early_exit stops once every beam has finished and gives the same
    tensors as the full max_len run."""
    vocab, eos = 6, 5
    calls = []

    def decode_fn(tokens, pos, state):
        calls.append(pos)
        g = torch.Generator().manual_seed(pos)
        logits = torch.randn(tokens.shape[0], vocab, generator=g)
        logits[:, eos] += 2.0 * pos                 # eos grows likelier
        return logits, {"h": state["h"] + 1}

    kw = dict(batch=2, beam_size=3, max_len=12, bos_id=0, eos_id=eos,
              vocab_size=vocab, length_penalty=0.6)
    full = beam_search(decode_fn, {"h": torch.zeros(6, 2)}, **kw)
    n_full = len(calls)
    early = beam_search(decode_fn, {"h": torch.zeros(6, 2)}, **kw,
                        early_exit=True)
    assert n_full == 12 and len(calls) - n_full < 12
    for a, b in zip(full, early):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- cross-package: BERT and training ---------------------------------------

def _bert_batch(seed=0, b=3, t=8, k=2):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, BERT["vocab"], (b, t)).astype(np.int32)
    pos = np.sort(rs.rand(b, t).argsort(1)[:, :k], 1).astype(np.int32)
    lens = np.array([8, 5, 6], np.int32)[:b]
    labels = rs.randint(0, BERT["vocab"], (b, k)).astype(np.int32)
    return toks, pos, lens, labels


def test_bert_hidden_logits_and_grads_match_jax():
    tree = bert_tree(1, **BERT, random_norms=True)
    toks, pos, lens, labels = _bert_batch()
    jm = JaxBert(**BERT, dropout=0.0)

    def jloss(params):
        logits = jm.apply({"params": params}, toks, pos, lens)
        return jnp.mean(JF.softmax_with_cross_entropy(logits, labels))

    @jax.jit
    def run(params):
        hidden = jm.apply({"params": params}, toks, None, lens)
        logits = jm.apply({"params": params}, toks, pos, lens)
        return hidden, logits, jax.grad(jloss)(params)
    hidden, logits, grads = run(_jvars(tree)["params"])

    m = load_jax_params(BertEncoder(**BERT, dropout=0.0, device="cpu"), tree)
    got_hidden = m(_t(toks), lengths=_t(lens))
    got_logits = m(_t(toks), _t(pos), _t(lens))
    softmax_with_cross_entropy(got_logits, _t(labels)).mean().backward()
    _close(got_hidden.detach().numpy(), np.asarray(hidden))
    _close(got_logits.detach().numpy(), np.asarray(logits))
    want = {k: np.asarray(v) for k, v in
            flatten_with_keys(jax.device_get(grads))}
    top = max(float(np.abs(w).max()) for w in want.values())
    got = {n: p.grad.numpy() for n, p in named_params(m)}
    assert set(got) == set(want)
    for n in want:
        # a gradient that is 0 in exact arithmetic (the key bias's) is
        # float32 noise on both sides: the floor is 1e-6 of the largest
        _close(got[n], want[n], floor=1e-6, top=top)


def _seq2seq_batch(seed):
    rs = np.random.RandomState(seed)
    src = rs.randint(2, SRC_V, (3, 9)).astype(np.int32)
    lens = np.array([9, 6, 4], np.int32)
    trg = rs.randint(2, TRG_V, (3, 8)).astype(np.int32)
    out = np.roll(trg, -1, axis=1)
    w = (rs.rand(3, 8) > 0.2).astype(np.float32)
    return src, lens, trg, out, w


def _jax_seq2seq_loss(module, variables, batch, rng, training):
    src, lens, trg, out, w = batch
    logits = module.apply(variables, src, trg, lens, training=training,
                          rngs=rng)
    ce = JF.softmax_with_cross_entropy(logits.astype(jnp.float32), out)
    return (jnp.sum(ce * w) / jnp.sum(w), {}), {}


def _seq2seq_loss(module, batch, generator, training):
    src, lens, trg, out, w = batch
    logits = module(src, trg, lens, generator=generator)
    ce = softmax_with_cross_entropy(logits.float(), out)
    return (ce * w).sum() / w.sum(), {}


def _jax_bert_loss(module, variables, batch, rng, training):
    toks, pos, lens, labels = batch
    logits = module.apply(variables, toks, pos, lens, training=training,
                          rngs=rng)
    return (jnp.mean(JF.softmax_with_cross_entropy(
        logits.astype(jnp.float32), labels)), {}), {}


def _bert_loss(module, batch, generator, training):
    toks, pos, lens, labels = batch
    logits = module(toks, pos, lens, generator=generator)
    return softmax_with_cross_entropy(logits.float(), labels).mean(), {}


@pytest.mark.parametrize("which", ["transformer", "bert"])
def test_five_adam_steps_match_jax(which):
    """5 Adam steps of the port's Trainer against JAX's Trainer (dropout
    0, the Transformer at one layer a side, lr 1e-3; Adam epsilon 1e-4, so the key biases' float32-noise
    gradients move neither package by +-lr): the loss curves within 1e-5
    relative and the parameters after the steps within 1e-5 of each
    tensor's largest magnitude."""
    if which == "transformer":
        # one layer each side: JAX compiles the whole step, and the
        # compile grows with the layers
        dims = dict(DIMS, num_layers=1)
        tree = transformer_tree(2, SRC_V, TRG_V, **dims, random_norms=True)
        jm = JaxTransformer(SRC_V, TRG_V, **dims, dropout=0.0,
                            max_len=MAX_LEN)
        model = load_jax_params(Transformer(SRC_V, TRG_V, **dims,
                                            dropout=0.0, max_len=MAX_LEN,
                                            device="cpu"), tree)
        batches = [_seq2seq_batch(s) for s in range(5)]
        jloss, loss = _jax_seq2seq_loss, _seq2seq_loss
    else:
        tree = bert_tree(2, **BERT, random_norms=True)
        jm = JaxBert(**BERT, dropout=0.0)
        model = load_jax_params(BertEncoder(**BERT, dropout=0.0,
                                            device="cpu"), tree)
        batches = [_bert_batch(s) for s in range(5)]
        jloss, loss = _jax_bert_loss, _bert_loss
    jopt = JaxAdam(1e-3, epsilon=1e-4)
    jtr = JaxTrainer(jm, jopt, jloss)
    params = _jvars(tree)["params"]
    ts = JaxTrainState(params=params, state={}, opt_state=jopt.init(params),
                       step=jnp.zeros((), jnp.int32))
    tr = Trainer(model, Adam(model.parameters(), 1e-3, epsilon=1e-4), loss)
    want, got = [], []
    for batch in batches:
        ts, jout = jtr.train_step(ts, tuple(jnp.asarray(x) for x in batch))
        want.append(float(jout["loss"]))
        got.append(float(tr.train_step(tuple(_t(x) for x in batch))["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    final = {k: np.asarray(v) for k, v in
             flatten_with_keys(jax.device_get(ts.params))}
    for k, v in flatten_with_keys(to_jax_params(model)["params"]):
        _close(v, final[k])
