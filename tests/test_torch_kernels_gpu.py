"""The port's CUDA kernels on the card (marked `gpu`).

Each test decides inside its body whether a card exists and skips
without one, so every worker collects the same tests. This file imports
no JAX, so it runs on the machine with the card (where JAX is absent):

    PTPU_TEST_REAL_DEVICE=1 python -m pytest tests/test_torch_kernels_gpu.py -m gpu

(PTPU_TEST_REAL_DEVICE=1 keeps tests/conftest.py from configuring JAX.)
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.engine import ServeEngine
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.testing import (PAGED_ARGS, QUANT_ARGS, RAGGED_ARGS,
                                      causal_lm_tree, int8_blocks,
                                      paged_case, ragged_case)

pytestmark = pytest.mark.gpu

CASES = {
    # name: (rows [(context_len, q_len)], H, Hkv, D, block_size, tile_q)
    "decode_only": ([(5, 1), (8, 1), (1, 1), (13, 1)], 4, 4, 8, 4, 4),
    "mixed": ([(7, 1), (10, 6), (4, 4), (17, 2)], 4, 4, 8, 4, 4),
    "gqa": ([(7, 3), (11, 1), (6, 6)], 8, 2, 16, 4, 4),
    "mqa": ([(12, 5), (3, 1)], 4, 1, 8, 8, 4),
    "tile_q_1": ([(7, 1), (10, 6), (9, 9)], 4, 2, 8, 4, 1),
    # the serving path's shapes: H 8, D 64, block 16, tile 8, with a
    # chunk from a block-aligned and one from an off-stride position
    "engine_shape": ([(300, 1), (160, 64), (250, 37), (40, 40)],
                     8, 8, 64, 16, 8),
    "engine_shape_d256": ([(70, 9), (33, 1)], 2, 1, 256, 16, 8),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _operands(name, dtype):
    rows, h, hkv, d, bs, tq = CASES[name]
    case = ragged_case(rows, h, hkv, d, bs, tq, pad_tiles=2, seed=0)
    ts = [torch.from_numpy(case[k]).cuda() for k in RAGGED_ARGS]
    return [t.to(dtype) if t.is_floating_point() else t for t in ts]


def _mixed_operands(name, dtype, which="odd"):
    """(mixed args, int8 kwargs, promoted args) on the card: a table
    that mixes fp and int8 ids, and the same blocks promoted."""
    rows, h, hkv, d, bs, tq = CASES[name]
    case = ragged_case(rows, h, hkv, d, bs, tq, pad_tiles=2, seed=0)
    mixed, promoted, n = int8_blocks(case, which, dtype)
    assert n > 0

    def dev(c):
        return [torch.from_numpy(c[k]).cuda().to(dtype)
                if k in ("q", "k_pool", "v_pool")
                else torch.from_numpy(c[k]).cuda() for k in RAGGED_ARGS]
    quant = {k: torch.from_numpy(mixed[k]).cuda() for k in QUANT_ARGS}
    return dev(mixed), quant, dev(promoted)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_kernel_matches_plain(name, dtype):
    """f32 at 1e-4; bf16 against the f32 plain version on the same
    bf16 values at 2e-2 (p is rounded to bf16 before P.V, the output
    to bf16)."""
    _need_card()
    dt = getattr(torch, dtype)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    ts = _operands(name, dt)
    before = paged.ragged_paged_attention.launches
    got = paged.ragged_paged_attention(*ts)
    torch.cuda.synchronize()
    assert paged.ragged_paged_attention.launches == before + 1
    assert got.dtype == dt and got.shape == ts[0].shape
    want = paged.ragged_paged_attention_reference(
        *[t.float() if t.is_floating_point() else t for t in ts])
    assert float((got.float() - want).abs().max()) <= atol


@pytest.mark.parametrize("which", ["odd", "all"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mixed_kernel_matches_plain(name, dtype, which):
    """The mixed kernel over a bias-encoded table against the plain
    mixed version in f32 on the same values: 1e-4 in f32, 2e-2 in
    bf16 (the kernel rounds dequantized values and p to bf16)."""
    _need_card()
    dt = getattr(torch, dtype)
    ts, quant, _ = _mixed_operands(name, dt, which)
    before = paged.ragged_paged_attention.mixed_launches
    got = paged.ragged_paged_attention(*ts, **quant, check_block_ids=True)
    torch.cuda.synchronize()
    assert paged.ragged_paged_attention.mixed_launches == before + 1
    want = paged.ragged_paged_attention_reference(
        *[t.float() if t.is_floating_point() else t for t in ts], **quant)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    assert float((got.float() - want).abs().max()) <= atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mixed_kernel_bit_exact_vs_promote_then_fp_kernel(name, dtype):
    """A direct int8 read gives exactly the bytes of the fp kernel over
    pools into which the same blocks were promoted with
    dequantize_block."""
    _need_card()
    dt = getattr(torch, dtype)
    ts, quant, promoted = _mixed_operands(name, dt)
    got = paged.ragged_paged_attention(*ts, **quant)
    want = paged.ragged_paged_attention(*promoted)
    assert torch.equal(got, want)


def test_fp_only_table_through_mixed_kernel_is_the_fp_kernel():
    _need_card()
    ts = _operands("gqa", torch.bfloat16)
    shape = (2,) + tuple(ts[1].shape[1:])
    quant = dict(kq_pool=torch.zeros(shape, dtype=torch.int8, device="cuda"),
                 vq_pool=torch.zeros(shape, dtype=torch.int8, device="cuda"),
                 k_scales=torch.ones(2, device="cuda"),
                 v_scales=torch.ones(2, device="cuda"))
    assert torch.equal(paged.ragged_paged_attention(*ts, **quant),
                       paged.ragged_paged_attention(*ts))


PAGED_CASES = {
    # name: (context_lens, H, Hkv, D, block_size)
    "small": ([1, 4, 7, 13], 4, 4, 8, 4),
    "gqa": ([3, 9, 16, 33], 8, 2, 16, 4),
    "mqa": ([5, 12], 4, 1, 8, 8),
    # the split path's widths: contexts from 1 to 1200, ends off-block
    "engine_shape": ([1, 16, 17, 300, 517, 1200], 8, 8, 64, 16),
    "engine_shape_gqa": ([33, 450, 1199], 8, 2, 64, 16),
    "d256": ([70, 33, 1], 2, 1, 256, 16),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_kernel_matches_plain(name, dtype):
    _need_card()
    dt = getattr(torch, dtype)
    lens, h, hkv, d, bs = PAGED_CASES[name]
    case = paged_case(lens, h, hkv, d, bs, seed=1)
    ts = [torch.from_numpy(case[k]).cuda() for k in PAGED_ARGS]
    ts = [t.to(dt) if t.is_floating_point() else t for t in ts]
    before = paged.paged_attention.launches
    got = paged.paged_attention(*ts, check_block_ids=True)
    torch.cuda.synchronize()
    assert paged.paged_attention.launches == before + 1
    assert got.dtype == dt and got.shape == ts[0].shape
    want = paged.paged_attention_reference(
        *[t.float() if t.is_floating_point() else t for t in ts])
    atol = 1e-4 if dt == torch.float32 else 2e-2
    assert float((got.float() - want).abs().max()) <= atol


def test_paged_kernel_rows_are_independent():
    """A row's output is the same alone as in its batch."""
    _need_card()
    lens, h, hkv, d, bs = PAGED_CASES["engine_shape_gqa"]
    case = paged_case(lens, h, hkv, d, bs, seed=2)
    ts = [torch.from_numpy(case[k]).cuda() for k in PAGED_ARGS]
    whole = paged.paged_attention(*ts)
    for i in range(len(lens)):
        one = paged.paged_attention(ts[0][i:i + 1].contiguous(), ts[1],
                                    ts[2], ts[3][i:i + 1].contiguous(),
                                    ts[4][i:i + 1].contiguous())
        assert torch.equal(one[0], whole[i])


def test_ragged_kernel_rows_are_independent():
    """A row's output does not depend on its neighbours: the same rows
    packed with extra pad tiles give bit-identical real segments."""
    _need_card()
    ts = _operands("mixed", torch.float32)
    tq = CASES["mixed"][5]
    fewer = list(ts)
    fewer[0] = ts[0][:-tq].contiguous()
    fewer[6] = ts[6][:-1].contiguous()
    fewer[7] = ts[7][:-1].contiguous()
    a = paged.ragged_paged_attention(*ts)
    b = paged.ragged_paged_attention(*fewer)
    assert torch.equal(a[:-2 * tq], b[:-tq])


def test_ragged_kernel_rejects_what_it_cannot_take():
    _need_card()
    ts = _operands("mixed", torch.float32)
    half = [t.half() if t.is_floating_point() else t for t in ts]
    with pytest.raises(TypeError, match="not supported"):
        paged.ragged_paged_attention(*half)
    mixed = list(ts)
    mixed[1] = ts[1].bfloat16()
    with pytest.raises(TypeError, match="must match"):
        paged.ragged_paged_attention(*mixed)
    wide = list(ts)
    wide[3] = ts[3].long()
    with pytest.raises(TypeError, match="int32"):
        paged.ragged_paged_attention(*wide)
    strided = list(ts)
    strided[0] = ts[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        paged.ragged_paged_attention(*strided)


def test_engine_on_card_goes_through_the_kernel():
    """A small engine on the card: one kernel launch per layer per
    step, batched streams equal solo streams, the cache quiesces."""
    _need_card()
    dims = dict(model_dim=64, num_heads=8, num_layers=2, ffn_dim=128,
                num_kv_heads=2)
    model = CausalLM(97, dropout=0.0, max_len=128, device="cuda", **dims)
    load_jax_params(model, causal_lm_tree(0, 97, **dims))
    kw = dict(max_batch_size=4, block_size=16, num_blocks=64,
              max_prefill_tokens=32, tile_q=8, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, n).tolist() for n in (5, 40, 17, 1)]
    eng = ServeEngine(model, registry=MetricsRegistry(), **kw)
    before = paged.ragged_paged_attention.launches
    batched = eng.generate(prompts, max_new_tokens=6)
    assert paged.ragged_paged_attention.launches - before == \
        eng.steps * dims["num_layers"]
    solo = [ServeEngine(model, registry=MetricsRegistry(), **kw)
            .generate([p], max_new_tokens=6)[0] for p in prompts]
    assert batched == solo
    assert len(eng.step_shapes) == 1
    eng.cache.assert_quiesced()


def test_int8_tier_engine_on_card_batched_equals_solo():
    """An engine with the int8 tier on the card: the shared prefix is
    quantized while fillers run, its fp copies are recycled, and the
    second wave reads it in place through the mixed kernel — one mixed
    launch per layer per step, none of the fp kernel. Each second-wave
    request replayed alone on an engine in the same state gives the
    same stream."""
    _need_card()
    dims = dict(model_dim=64, num_heads=8, num_layers=2, ffn_dim=128,
                num_kv_heads=2)
    model = CausalLM(97, dropout=0.0, max_len=128, device="cuda", **dims)
    load_jax_params(model, causal_lm_tree(0, 97, **dims))
    kw = dict(max_batch_size=4, block_size=16, num_blocks=24,
              max_prefill_tokens=32, tile_q=8, kv_compress_blocks=64,
              device="cuda")
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, 97, 32).tolist()
    wave1 = [prefix + rng.integers(0, 97, n).tolist() for n in (3, 9)]
    fillers = [rng.integers(0, 97, 60).tolist() for _ in range(8)]
    wave2 = [prefix + rng.integers(0, 97, n).tolist() for n in (5, 11, 2)]

    def warm(eng):
        eng.generate(wave1, max_new_tokens=4)
        for i in range(0, len(fillers), 2):
            eng.generate(fillers[i:i + 2], max_new_tokens=4)

    eng = ServeEngine(model, registry=MetricsRegistry(), **kw)
    warm(eng)
    assert tuple(prefix[:16]) not in eng.cache._index
    assert tuple(prefix[:16]) in eng.cache._cindex
    fp0 = paged.ragged_paged_attention.launches
    mixed0 = paged.ragged_paged_attention.mixed_launches
    steps0 = eng.steps
    batched = eng.generate(wave2, max_new_tokens=6)
    assert paged.ragged_paged_attention.launches == fp0
    assert paged.ragged_paged_attention.mixed_launches - mixed0 == \
        (eng.steps - steps0) * dims["num_layers"]
    st = eng.cache.stats()
    assert st["direct_int8_reads"] > 0 and st["promote_total"] == 0
    assert len(eng.step_shapes) == 1
    eng.cache.assert_quiesced()
    for prompt, stream in zip(wave2, batched):
        alone = ServeEngine(model, registry=MetricsRegistry(), **kw)
        warm(alone)
        assert alone.generate([prompt], max_new_tokens=6)[0] == stream
