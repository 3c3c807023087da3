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

from paddle_tpu_torch.core import Trainer
from paddle_tpu_torch.engine import ServeEngine
from paddle_tpu_torch.kernels import attention, flash
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.ops import linear_cross_entropy
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.testing import (FLASH_ARGS, OOV_DIMS, OOV_ENGINE,
                                      OOV_KERNEL_STREAMS, OOV_NEW_TOKENS,
                                      OOV_PROMPTS, OOV_VOCAB, PAGED_ARGS,
                                      QUANT_ARGS, RAGGED_ARGS,
                                      causal_lm_tree, decode_as_ragged,
                                      flash_case, int8_blocks, lm_stream,
                                      packed_segment_ids, paged_case,
                                      ragged_case)

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
    # decode rows at contexts around the kv split S = 256 (S - 1, S,
    # S + 1, 2S + BS - 1) and at the LM's max_len 2048
    "split_edges": ([(255, 1), (256, 1), (257, 1), (527, 1), (2048, 1)],
                    8, 8, 64, 16, 8),
    # a chunk across the first split boundary, one across two
    "chunk_across_splits": ([(300, 100), (712, 456), (20, 1)],
                            8, 8, 64, 16, 8),
    "gqa_across_splits": ([(600, 40), (530, 1), (257, 9)], 8, 2, 64, 16, 8),
    # one rank's heads under tensor parallelism (tp=2): the LM's 8 heads
    # over 8 give 4 over 4 a rank; the GQA test fixture's 4 over 2 give
    # 2 over 1
    "tp_rank_4_over_4": ([(300, 1), (712, 456), (40, 40)], 4, 4, 64, 16, 8),
    "tp_rank_2_over_1": ([(7, 3), (11, 1), (270, 9)], 2, 1, 8, 4, 4),
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
# decode contexts around the kv split S = 256 (S - 1, S, S + 1,
# 2S + BS - 1) and at the LM's max_len 2048, MHA and GQA 8:2
PAGED_CASES.update({
    f"split_edges_d{d}{'_gqa' if hkv == 2 else ''}":
        ([255, 256, 257, 527, 2048], 8, hkv, d, 16)
    for d in (64, 128, 256) for hkv in (8, 2)})


def _paged_operands(name, dtype, seed=1, case=None):
    """(numpy case, its operands on the card in `dtype`)."""
    if case is None:
        lens, h, hkv, d, bs = PAGED_CASES[name]
        case = paged_case(lens, h, hkv, d, bs, seed=seed)
    ts = [torch.from_numpy(case[k]).cuda() for k in PAGED_ARGS]
    return case, [t.to(dtype) if t.is_floating_point() else t for t in ts]


def _paged_plain(ts):
    return paged.paged_attention_reference(
        *[t.float() if t.is_floating_point() else t for t in ts])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_kernel_matches_plain(name, dtype):
    _need_card()
    dt = getattr(torch, dtype)
    _, ts = _paged_operands(name, dt)
    before = paged.paged_attention.launches
    got = paged.paged_attention(*ts, check_block_ids=True)
    torch.cuda.synchronize()
    assert paged.paged_attention.launches == before + 1
    assert got.dtype == dt and got.shape == ts[0].shape
    atol = 1e-4 if dt == torch.float32 else 2e-2
    assert float((got.float() - _paged_plain(ts)).abs().max()) <= atol


@pytest.mark.parametrize("tile_q", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["engine_shape", "engine_shape_gqa", "d256",
                                  "split_edges_d64", "split_edges_d128_gqa"])
def test_paged_kernel_is_kernel_1_on_decode_rows(name, dtype, tile_q):
    """Kernel 3 is kernel 1 over the decode packing: its output equals,
    bit for bit, kernel 1's for the same rows packed as ragged decode
    rows, one to a tile of tile_q 1 or 8 (the engine's)."""
    _need_card()
    dt = getattr(torch, dtype)
    case, ts = _paged_operands(name, dt, seed=4)
    rcase = decode_as_ragged(case, tile_q)
    rts = [torch.from_numpy(rcase[k]).cuda() for k in RAGGED_ARGS]
    rts = [t.to(dt) if t.is_floating_point() else t for t in rts]
    got = paged.paged_attention(*ts)
    assert torch.equal(got, paged.ragged_paged_attention(*rts)[::tile_q])


@pytest.mark.parametrize("max_blocks", [4, 64])        # one split; four
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_gives_zeros_at_context_0(dtype, max_blocks):
    """A row at context 0 reads no block (its table points at a block of
    NaNs) and gets exact zeros, as the Pallas kernel's acc / max(l,
    1e-30); the output's memory held NaNs before the call. The rows
    beside it match plain over the pools without the NaNs (the plain
    version gathers every table entry, and 0 * NaN poisons its P.V)."""
    _need_card()
    dt = getattr(torch, dtype)
    clean = paged_case([0, 37, 0, 60], 8, 2, 64, 16, max_blocks=max_blocks,
                       seed=5)
    case = dict(clean, k_pool=clean["k_pool"].copy(),
                v_pool=clean["v_pool"].copy())
    case["k_pool"][0] = case["v_pool"][0] = np.nan    # scratch block 0
    _, ts = _paged_operands(None, dt, case=case)
    # freed at once, so the allocator hands its block to the output
    torch.full_like(ts[0], float("nan"))
    got = paged.paged_attention(*ts)
    torch.cuda.synchronize()
    assert torch.equal(got[[0, 2]], torch.zeros_like(got[[0, 2]]))
    atol = 1e-4 if dt == torch.float32 else 2e-2
    want = _paged_plain(_paged_operands(None, dt, case=clean)[1])
    assert float((got[[1, 3]].float() - want[[1, 3]]).abs().max()) <= atol


@pytest.mark.parametrize("max_blocks", [8, 17])        # one split; two
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_past_its_table_matches_plain(dtype, max_blocks):
    """Contexts past the table's MB * BS positions see those positions
    (the Pallas grid stops at MB), beside a row inside the table."""
    _need_card()
    dt = getattr(torch, dtype)
    case = paged_case([40, 300, 517], 8, 2, 64, 16, seed=6)
    case["block_tables"] = np.ascontiguousarray(
        case["block_tables"][:, :max_blocks])
    _, ts = _paged_operands(None, dt, case=case)
    got = paged.paged_attention(*ts, check_block_ids=True)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    assert float((got.float() - _paged_plain(ts)).abs().max()) <= atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_is_deterministic(dtype):
    """Ten calls over rows that span up to 8 kv splits give equal bits."""
    _need_card()
    _, ts = _paged_operands("split_edges_d64_gqa", getattr(torch, dtype))
    first = paged.paged_attention(*ts)
    for _ in range(9):
        assert torch.equal(paged.paged_attention(*ts), first)


def test_paged_kernel_smem_is_the_library_count():
    """The decode call's shared memory (tile_q 1, G rows), as the wrapper
    counts it, is the library's count for the ragged split kernel."""
    _need_card()
    for dt in (torch.float32, torch.bfloat16):
        for d in (8, 64, 128, 256):
            for g in (1, 2, 4, 8):
                assert (paged.shared_memory_bytes(1, g, d, 16,
                                                  "paged_attention", dt)
                        == paged.library_smem_bytes(dt, d, g, 16))


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


def _position_case(p, long_start, long_len, seed):
    """One row's K/V (800 positions, H 8 = Hkv, D 64, BS 16, tile_q 8)
    read by three rows through the same table: a decode row at position
    p (ctx p + 1), a 4-query chunk ending at p, and a chunk of long_len
    queries from long_start (ctx past p). Query p holds the same vector
    in all three. Returns the case (testing.ragged_case's keys, the null
    row last) and the flat index of query p in each row."""
    h, d, bs, tq, length = 8, 64, 16, 8, 800
    rng = np.random.default_rng(seed)
    nblk = length // bs
    ids = rng.permutation(np.arange(1, nblk + 1)).astype(np.int32)
    rows = [(p + 1, p, 1), (p + 1, p - 3, 4),
            (long_start + long_len, long_start, long_len)]
    bt = np.zeros((len(rows) + 1, nblk), np.int32)
    cl = np.ones((len(rows) + 1,), np.int32)
    qs = np.zeros((len(rows) + 1,), np.int32)
    tile_rows, tile_offs, where = [], [], []
    for i, (ctx, start, qlen) in enumerate(rows):
        bt[i], cl[i], qs[i] = ids, ctx, start
        where.append(len(tile_rows) * tq + p - start)
        for k in range(-(-qlen // tq)):
            tile_rows.append(i)
            tile_offs.append(k * tq)
    tile_rows.append(len(rows))           # a pad tile on the null row
    tile_offs.append(0)
    q = rng.standard_normal((len(tile_rows) * tq, h, d), np.float32)
    q[where] = q[where[0]]
    shape = (nblk + 1, bs, h, d)
    case = {"q": q, "k_pool": rng.standard_normal(shape, np.float32),
            "v_pool": rng.standard_normal(shape, np.float32),
            "block_tables": bt, "context_lens": cl, "q_starts": qs,
            "tile_rows": np.asarray(tile_rows, np.int32),
            "tile_offs": np.asarray(tile_offs, np.int32)}
    return case, where


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,long_start,long_len", [
    (252, 201, 100),    # in split 0; the long chunk's tile reaches split 1
    (767, 700, 100),    # the last position of split 2; the tile reaches 3
])
def test_ragged_output_depends_on_position_not_packing(p, long_start,
                                                       long_len, dtype,
                                                       mixed):
    """A query's output bits depend on its position, its row's ctx and
    K/V only: query p reached as a decode row, as the last query of a
    short chunk and inside a long chunk (another ctx, another tile
    offset, a tile that spans one more kv split, so its output goes
    through the combine kernel where the decode row's is written
    directly) gives equal bits, in one call and alone."""
    _need_card()
    dt = getattr(torch, dtype)
    case, where = _position_case(p, long_start, long_len, seed=p)
    quant = {}
    if mixed:
        case, _, _ = int8_blocks(case, "odd", dt)
        quant = {k: torch.from_numpy(case[k]).cuda() for k in QUANT_ARGS}
    ts = [torch.from_numpy(case[k]).cuda() for k in RAGGED_ARGS]
    ts = [t.to(dt) if t.is_floating_point() else t for t in ts]
    out = paged.ragged_paged_attention(*ts, **quant)
    for i in where[1:]:
        assert torch.equal(out[i], out[where[0]])
    # the decode row alone: another T and NT
    alone = list(ts)
    alone[0] = ts[0][:8].contiguous()
    alone[6] = ts[6][:1].contiguous()
    alone[7] = ts[7][:1].contiguous()
    assert torch.equal(paged.ragged_paged_attention(*alone, **quant)[0],
                       out[where[0]])


def _window_case(start, k, hkv, seed):
    """One sequence's K/V (800 positions, H 8, D 64, BS 16, tile_q 8)
    read by a speculative decode window — one row of 1 + k queries at
    positions start..start+k (ctx start + k + 1) — and by k + 1 decode
    rows, one a position (ctx p + 1); window query j holds the same
    vector as decode row j. Returns the case and, for each position,
    (flat index in the window, flat index of its decode row)."""
    h, d, bs, tq, length = 8, 64, 16, 8, 800
    rng = np.random.default_rng(seed)
    nblk = length // bs
    ids = rng.permutation(np.arange(1, nblk + 1)).astype(np.int32)
    rows = [(start + k + 1, start, k + 1)] + [
        (start + j + 1, start + j, 1) for j in range(k + 1)]
    bt = np.zeros((len(rows) + 1, nblk), np.int32)
    cl = np.ones((len(rows) + 1,), np.int32)
    qs = np.zeros((len(rows) + 1,), np.int32)
    tile_rows, tile_offs = [], []
    for i, (ctx, q_start, qlen) in enumerate(rows):
        bt[i], cl[i], qs[i] = ids, ctx, q_start
        for t in range(-(-qlen // tq)):
            tile_rows.append(i)
            tile_offs.append(t * tq)
    tile_rows.append(len(rows))           # a pad tile on the null row
    tile_offs.append(0)
    q = rng.standard_normal((len(tile_rows) * tq, h, d), np.float32)
    pairs = [(j, (1 + j) * tq) for j in range(k + 1)]
    for w, r in pairs:
        q[r] = q[w]
    shape = (nblk + 1, bs, hkv, d)
    case = {"q": q, "k_pool": rng.standard_normal(shape, np.float32),
            "v_pool": rng.standard_normal(shape, np.float32),
            "block_tables": bt, "context_lens": cl, "q_starts": qs,
            "tile_rows": np.asarray(tile_rows, np.int32),
            "tile_offs": np.asarray(tile_offs, np.int32)}
    return case, pairs


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start,k,hkv", [
    (203, 4, 8),     # inside one block, off the block grid
    (254, 4, 8),     # across a block boundary and the kv split at 256
    (509, 7, 2),     # a full tile across the split at 512, GQA
    (16, 1, 8),      # one draft from a block-aligned start
])
def test_speculative_window_equals_single_token_rows(start, k, hkv, dtype,
                                                     mixed):
    """A decode window of 1 + k tokens at an off-block start (what a
    speculating engine's decode row is) gives, row for row, the bits of
    k + 1 single-token decode rows at the same positions: kernel 1, and
    kernel 2 with every other block int8."""
    _need_card()
    dt = getattr(torch, dtype)
    case, pairs = _window_case(start, k, hkv, seed=start + k)
    quant = {}
    if mixed:
        case, _, _ = int8_blocks(case, "odd", dt)
        quant = {n: torch.from_numpy(case[n]).cuda() for n in QUANT_ARGS}
    ts = [torch.from_numpy(case[n]).cuda() for n in RAGGED_ARGS]
    ts = [t.to(dt) if t.is_floating_point() else t for t in ts]
    out = paged.ragged_paged_attention(*ts, **quant)
    assert torch.isfinite(out).all()
    for w, r in pairs:
        assert torch.equal(out[w], out[r]), (w, r)


class _CycleDrafter:
    """Always drafts k tokens (the last token + 1, + 2, ... mod the
    vocabulary): every decode row of the step is a speculative
    window."""

    def __init__(self, k=4, vocab=97):
        self.k, self.vocab = k, vocab

    def propose(self, tokens, max_tokens=None):
        cap = self.k if max_tokens is None else min(self.k, max_tokens)
        return [(tokens[-1] + i) % self.vocab for i in range(1, cap + 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_speculating_graph_step_equals_eager_step(dtype):
    """An engine with spec_k=4 captures one graph whose [B, 5, V] logits
    equal the eager step's bit for bit after every step with draft
    windows in the batch; its batched streams equal each request served
    alone on a fresh speculating engine."""
    _need_card()
    model = _graph_model(getattr(torch, dtype))
    kw = dict(GRAPH_ENGINE, spec_k=4)
    eng = ServeEngine(model, registry=MetricsRegistry(),
                      drafter=_CycleDrafter(), **kw)
    wave1, _, _ = _graph_traffic(seed=3)
    prompts = wave1 + [[5, 9, 2], list(range(1, 30))]
    reqs = [eng.add_request(p, max_new_tokens=9) for p in prompts]
    draft_steps = 0
    while eng.step():
        graph = eng.step_graph.logits.clone()
        assert graph.shape == (4, 5, 97)
        assert torch.isfinite(graph).all()
        assert torch.equal(graph, eng.step_graph.eager())
        idx = eng.step_graph.operands["last_idx"]
        draft_steps += bool((idx[:, 1:] != idx[:, :1]).any())
    assert draft_steps > 0 and len(eng.step_graph.graphs) == 1
    assert eng.obs.get("ptpu_spec_drafted_tokens_total").value > 0
    for prompt, r in zip(prompts, reqs):
        alone = ServeEngine(model, registry=MetricsRegistry(),
                            drafter=_CycleDrafter(), **kw)
        assert alone.generate([prompt], max_new_tokens=9)[0] == r.generated


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_kernels_are_deterministic(dtype, mixed):
    """Ten calls over chunks that span several kv splits give the same
    bits: the splits are combined in a fixed order, with no atomics."""
    _need_card()
    dt = getattr(torch, dtype)
    if mixed:
        ts, quant, _ = _mixed_operands("chunk_across_splits", dt)
    else:
        ts, quant = _operands("chunk_across_splits", dt), {}
    first = paged.ragged_paged_attention(*ts, **quant)
    for _ in range(9):
        assert torch.equal(paged.ragged_paged_attention(*ts, **quant), first)


def test_ragged_schedule_smem_is_the_library_count():
    """The wrapper's pure-Python shared-memory count of a split-kernel
    CTA (what it checks against the card's limit) is the kernel's own."""
    _need_card()
    for dt in (torch.float32, torch.bfloat16):
        for d in (8, 40, 64, 128, 136, 256):
            for rows, bs in ((1, 16), (8, 16), (16, 4), (32, 1), (64, 8)):
                assert (paged.ragged_schedule(dt, d, rows, bs).smem_bytes
                        == paged.library_smem_bytes(dt, d, rows, bs))


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
    assert len(eng.step_graph.graphs) == 1
    eng.cache.assert_quiesced()


def test_capture_survives_a_garbage_engine():
    """An engine that became garbage (engines hold reference cycles, so
    the cyclic collector frees them) must not be collected while another
    engine captures its graph: destroying a graph is a CUDA call that
    invalidates a capture in progress. With the collector at its most
    eager, build engines one after another."""
    import gc

    _need_card()
    dims = dict(model_dim=64, num_heads=8, num_layers=2, ffn_dim=128)
    model = CausalLM(97, dropout=0.0, max_len=128, device="cuda", **dims)
    load_jax_params(model, causal_lm_tree(0, 97, **dims))
    kw = dict(max_batch_size=4, block_size=16, num_blocks=64,
              max_prefill_tokens=32, tile_q=8, device="cuda")
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        eng = None
        for _ in range(3):
            eng = None      # the last engine is garbage from here
            eng = ServeEngine(model, registry=MetricsRegistry(), **kw)
            assert len(eng.step_graph.graphs) == 1
            eng.generate([[1, 2, 3]], max_new_tokens=2)
    finally:
        gc.set_threshold(*threshold)


def test_tp2_engine_on_a_shared_card():
    """A tp=2 engine with both ranks on one card (gloo data plane): fp
    streams equal a tp=1 engine's, every rank launches kernel 1 once a
    layer a step (4 query heads over 2 kv heads split 2 over 1 a rank),
    a rank holds half the pool bytes, and the worker exits 0."""
    import os

    _need_card()
    dims = dict(model_dim=64, num_heads=4, num_layers=2, ffn_dim=128,
                num_kv_heads=2)
    model = CausalLM(97, dropout=0.0, max_len=128, device="cuda", **dims)
    load_jax_params(model, causal_lm_tree(0, 97, **dims))
    kw = dict(max_batch_size=4, block_size=16, num_blocks=64,
              max_prefill_tokens=32, tile_q=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, n).tolist() for n in (5, 40, 17, 1)]
    ref = ServeEngine(model, registry=MetricsRegistry(), device="cuda", **kw)
    want = ref.generate(prompts, max_new_tokens=6)
    prev = os.environ.get("PTPU_SERVE_ALLREDUCE")
    os.environ["PTPU_SERVE_ALLREDUCE"] = "fp"
    try:
        eng = ServeEngine(model, registry=MetricsRegistry(), tp_size=2,
                          device=["cuda:0", "cuda:0"], **kw)
    finally:
        if prev is None:
            os.environ.pop("PTPU_SERVE_ALLREDUCE")
        else:
            os.environ["PTPU_SERVE_ALLREDUCE"] = prev
    try:
        assert eng.tp_backend == "gloo"
        eng.rank_state(reset_launches=True)
        before = paged.ragged_paged_attention.launches
        assert eng.generate(prompts, max_new_tokens=6) == want
        states = eng.rank_state()
        launches = [s["launches"]["ragged_paged_attention.launches"]
                    for s in states]
        launches[0] -= before
        assert launches == [eng.steps * dims["num_layers"]] * 2
        assert [2 * s["pool_bytes"] for s in states] == \
            [ref.cache.per_chip_pool_bytes()] * 2
        assert eng.step_graph.compiles == 1 and eng.step_graph.graphs == []
        eng.cache.assert_quiesced()
    finally:
        eng.close()
    assert eng.worker_exit_codes == [0]


def test_out_of_vocabulary_id_leaves_the_card_serving():
    """A prompt with an id >= V on the card: its embedding row is NaN
    (no device-side assert), it streams token 0, the other request of
    its batch is unharmed, and nothing stays running. Requests served
    after it in the same process reuse its blocks on a small pool: the
    CUDA context survived, and every stream is the JAX engine's through
    its Pallas kernel (testing.OOV_KERNEL_STREAMS, held against JAX in
    tests/test_torch_engine.py)."""
    _need_card()
    model = CausalLM(OOV_VOCAB, dropout=0.0, max_len=64, device="cuda",
                     **OOV_DIMS)
    load_jax_params(model, causal_lm_tree(0, OOV_VOCAB, **OOV_DIMS))
    eng = ServeEngine(model, registry=MetricsRegistry(), device="cuda",
                      **OOV_ENGINE)
    streams = [eng.generate(p, max_new_tokens=OOV_NEW_TOKENS)
               for p in OOV_PROMPTS]
    torch.cuda.synchronize()
    assert not eng.scheduler.running and not eng.scheduler.waiting
    eng.cache.assert_quiesced()
    assert streams == OOV_KERNEL_STREAMS


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


# -- the step as one captured CUDA graph (engine/step_graph.py) ----------

GRAPH_DIMS = dict(model_dim=64, num_heads=8, num_layers=2, ffn_dim=128,
                  num_kv_heads=2)
GRAPH_ENGINE = dict(max_batch_size=4, block_size=16, num_blocks=24,
                    max_prefill_tokens=32, tile_q=8, device="cuda")


def _graph_model(dtype):
    model = CausalLM(97, dropout=0.0, max_len=128, device="cuda",
                     dtype=dtype, **GRAPH_DIMS)
    return load_jax_params(model, causal_lm_tree(0, 97, random_norms=True,
                                                 **GRAPH_DIMS))


def _graph_traffic(seed=1):
    """(wave 1 on a prefix, fillers that recycle its fp blocks on the
    24-block pool, wave 2 on the prefix)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 97, 32).tolist()
    return ([prefix + rng.integers(0, 97, n).tolist() for n in (3, 40)],
            [[rng.integers(0, 97, 60).tolist() for _ in range(2)]
             for _ in range(4)],
            [prefix + rng.integers(0, 97, n).tolist() for n in (5, 11, 2)])


@pytest.mark.parametrize("compress", [0, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_step_equals_eager_step(dtype, compress):
    """After every step of three waves (chunked prefill, decode rows
    riding, and with the int8 tier a wave that reads the prefix in
    place), the model's eager step on the same staged operands and
    pools gives the graph's logits bit for bit: fp engine (kernel 1)
    and int8-tier engine (kernel 2), f32 and bf16."""
    _need_card()
    eng = ServeEngine(_graph_model(getattr(torch, dtype)),
                      registry=MetricsRegistry(),
                      kv_compress_blocks=compress, **GRAPH_ENGINE)
    wave1, fillers, wave2 = _graph_traffic()
    int8_steps = 0
    for wave in [wave1, *fillers, wave2]:
        for p in wave:
            eng.add_request(p, max_new_tokens=4)
        while eng.step():
            graph = eng.step_graph.logits.clone()
            assert torch.isfinite(graph).all()
            assert torch.equal(graph, eng.step_graph.eager())
            int8_steps += bool(
                (eng.step_graph.operands["block_tables"] < 0).any())
    assert len(eng.step_graph.graphs) == 1
    assert (int8_steps > 0) == bool(compress)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_engine_batched_equals_solo(dtype):
    """Every engine replays its own graph: a batched wave's streams equal
    each request served alone on a fresh engine."""
    _need_card()
    model = _graph_model(getattr(torch, dtype))
    wave1, _, _ = _graph_traffic(seed=2)
    prompts = wave1 + [[5, 9, 2], list(range(1, 30))]
    eng = ServeEngine(model, registry=MetricsRegistry(), **GRAPH_ENGINE)
    batched = eng.generate(prompts, max_new_tokens=6)
    for prompt, stream in zip(prompts, batched):
        alone = ServeEngine(model, registry=MetricsRegistry(),
                            **GRAPH_ENGINE)
        assert alone.generate([prompt], max_new_tokens=6)[0] == stream
        assert len(alone.step_graph.graphs) == 1


def test_graph_direct_int8_read_equals_promote():
    """The same traffic through two graph engines, one reading the
    int8-resident prefix in place and one promoting it to fp first,
    gives the same streams (f32)."""
    _need_card()
    model = _graph_model(torch.float32)
    wave1, fillers, wave2 = _graph_traffic()
    streams, stats = [], []
    for hits in (0, 1):
        eng = ServeEngine(model, registry=MetricsRegistry(),
                          kv_compress_blocks=64, kv_promote_hits=hits,
                          **GRAPH_ENGINE)
        for wave in [wave1, *fillers]:
            eng.generate(wave, max_new_tokens=4)
        streams.append(eng.generate(wave2, max_new_tokens=6))
        stats.append(eng.cache.stats())
        assert len(eng.step_graph.graphs) == 1
    assert streams[0] == streams[1]
    assert stats[0]["direct_int8_reads"] > 0 and stats[0]["promote_total"] == 0
    assert stats[1]["promote_total"] > 0 and stats[1]["direct_int8_reads"] == 0


@pytest.mark.parametrize("compress", [0, 64])
def test_one_graph_per_engine_across_waves(compress):
    """Capture at construction launches nothing that counts; three waves
    later the engine holds the same single graph, the gauge reads 1,
    and the counted launches are steps x layers, all of one kernel."""
    _need_card()
    model = _graph_model(torch.bfloat16)
    before = (paged.ragged_paged_attention.launches,
              paged.ragged_paged_attention.mixed_launches)
    eng = ServeEngine(model, registry=MetricsRegistry(),
                      kv_compress_blocks=compress, **GRAPH_ENGINE)
    assert (paged.ragged_paged_attention.launches,
            paged.ragged_paged_attention.mixed_launches) == before
    graph = eng.step_graph.graphs[0]
    assert eng.step_graph.capture_ms > 0 and eng.step_graph.warmup_ms > 0
    wave1, fillers, wave2 = _graph_traffic()
    for wave in (wave1, fillers[0], wave2):
        eng.generate(wave, max_new_tokens=5)
        assert eng.step_graph.graphs == [graph]
        assert eng.obs.get("ptpu_engine_compiles").value == 1
    counted = (paged.ragged_paged_attention.launches - before[0],
               paged.ragged_paged_attention.mixed_launches - before[1])
    want = eng.steps * GRAPH_DIMS["num_layers"]
    assert counted == ((0, want) if compress else (want, 0))
    assert len(eng.step_shapes) == 1
    eng.cache.assert_quiesced()


@pytest.mark.parametrize("which", ["pools", "qpools", "qscales"])
def test_graph_rebound_pool_raises(which):
    """A pool rebound under the graph raises before the next replay
    instead of the graph writing the old address."""
    _need_card()
    eng = ServeEngine(_graph_model(torch.float32),
                      registry=MetricsRegistry(), kv_compress_blocks=64,
                      **GRAPH_ENGINE)
    eng.generate([[5, 9, 2]], max_new_tokens=2)
    layers = getattr(eng.cache, which)
    layers[0] = (layers[0][0].clone(), layers[0][1])
    with pytest.raises(RuntimeError, match="pools moved"):
        eng.generate([[5, 9, 2]], max_new_tokens=2)


# -- flash attention: kernels 4 (forward), 5 (dq) and 6 (dk/dv) ---------

def _flash_mode(mode, t, b):
    """(kwargs of the flash functions, q_seg, kv_seg, seed) of a mask
    mode at sequence length t; every query sees at least one key."""
    kw, segs, seed = {}, (None, None), None
    if mode in ("causal", "dropout"):
        kw["causal"] = True
    if mode == "kv_len":
        kw["kv_len"] = max(1, (2 * t) // 3)
    if mode in ("segments", "dropout"):
        rows = [packed_segment_ids((t // 3, t // 2), t),
                packed_segment_ids((t - t // 4,), t)]
        ids = torch.from_numpy(np.stack([rows[i % 2] for i in range(b)]))
        ids = ids.cuda()
        segs = (ids, ids)
    if mode == "dropout":
        kw["dropout_rate"] = 0.1
        seed = torch.tensor([-123456789], dtype=torch.int32, device="cuda")
    return kw, segs, seed


FLASH_MODES = ("full", "causal", "kv_len", "segments", "dropout")


def _check_flash_kernels(t, d, dtype, mode, b=2, h=2, t_k=None):
    """Each of the three kernels against its plain version on the same
    inputs: f32 at 1e-5 (o, lse) and 1e-4 (dq, dk, dv); bf16 against the
    plain version run in f32 on the same bf16 values at 2e-2 (absolute
    and relative: the kernel rounds p, ds and g to bf16 on the way).
    t_k (default t): the key length; segment modes need t_k == t."""
    dt = getattr(torch, dtype)
    t_k = t if t_k is None else t_k
    case = flash_case(b, t, t_k, h, d, seed=t + d)
    q, k, v, do = (torch.from_numpy(case[x]).cuda().to(dt)
                   for x in FLASH_ARGS)
    kw, (q_seg, kv_seg), seed = _flash_mode(mode, t_k, b)
    kw["scale"] = d ** -0.5
    otol = dict(atol=1e-5, rtol=1e-5) if dt == torch.float32 else dict(
        atol=2e-2, rtol=2e-2)
    gtol = dict(atol=1e-4, rtol=1e-4) if dt == torch.float32 else otol
    f = [x.float() for x in (q, k, v, do)]
    before = (flash.flash_fwd.launches, flash.flash_dq.launches,
              flash.flash_dkv.launches)
    o, lse = flash.flash_fwd(q, k, v, q_seg, kv_seg, seed, **kw)
    o_ref, lse_ref = flash.flash_fwd_reference(*f[:3], q_seg, kv_seg, seed,
                                               **kw)
    torch.cuda.synchronize()
    assert o.dtype == dt and lse.shape == (b, h, t)
    torch.testing.assert_close(o.float(), o_ref, **otol)
    torch.testing.assert_close(lse, lse_ref, **otol)
    o_in = o_ref.to(dt)
    args = (q, k, v, o_in, lse_ref, do, q_seg, kv_seg, seed)
    ref_args = (*f[:3], o_in.float(), lse_ref, f[3], q_seg, kv_seg, seed)
    dq = flash.flash_dq(*args, **kw)
    dk, dv = flash.flash_dkv(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        dq.float(), flash.flash_dq_reference(*ref_args, **kw), **gtol)
    dk_ref, dv_ref = flash.flash_dkv_reference(*ref_args, **kw)
    torch.testing.assert_close(dk.float(), dk_ref, **gtol)
    torch.testing.assert_close(dv.float(), dv_ref, **gtol)
    assert (flash.flash_fwd.launches, flash.flash_dq.launches,
            flash.flash_dkv.launches) == tuple(n + 1 for n in before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 128, 200, 256])
@pytest.mark.parametrize("t", [1, 17, 64, 300, 1024])
def test_flash_kernels_match_plain_causal(t, d, dtype):
    _need_card()
    _check_flash_kernels(t, d, dtype, "causal")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [17, 300, 1024])
@pytest.mark.parametrize("mode", FLASH_MODES)
def test_flash_kernels_match_plain_masks(mode, t, dtype):
    _need_card()
    _check_flash_kernels(t, 64, dtype, mode)


# (b, h, t_q, t_k, d, mode): shapes the bf16 tensor-core kernels (128
# query rows and 64 keys per CTA in the forward and dq, 64 query rows at
# D 256 in dq, 128 or 64 keys and 64 query rows a stage in dk/dv, head
# dims padded to 64, 128 or 256) tile unevenly; f32 runs the same
# shapes through the SIMT kernels
TC_SHAPES = {
    "cross_causal_tq_gt_tk": (2, 2, 333, 200, 64, "causal"),
    "cross_causal_tq_lt_tk": (2, 2, 200, 333, 64, "causal"),
    "cross_kv_len": (2, 2, 300, 517, 64, "kv_len"),
    "t127": (2, 2, 127, 127, 64, "causal"),
    "t129": (2, 2, 129, 129, 64, "causal"),
    "t2047": (1, 2, 2047, 2047, 64, "causal"),
    "t2049": (1, 2, 2049, 2049, 64, "causal"),
    "t4096": (1, 2, 4096, 4096, 64, "causal"),
    "bh_over_132_sms": (9, 16, 256, 256, 64, "causal"),
    "d40_padded": (2, 2, 300, 300, 40, "dropout"),
    "d200_padded": (2, 2, 300, 300, 200, "segments"),
    "train_shape_dropout": (4, 8, 2048, 2048, 64, "dropout"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(TC_SHAPES))
def test_flash_kernels_match_plain_uneven_shapes(shape, dtype):
    _need_card()
    b, h, t_q, t_k, d, mode = TC_SHAPES[shape]
    _check_flash_kernels(t_q, d, dtype, mode, b=b, h=h, t_k=t_k)


@pytest.mark.parametrize("d", [64, 256])
def test_flash_kernels_match_plain_segment_pair(d):
    """Cross lengths (Tq != Tk) with a (q_seg, kv_seg) pair."""
    _need_card()
    case = flash_case(1, 200, 333, 2, d, seed=3)
    q, k, v, do = (torch.from_numpy(case[x]).cuda() for x in FLASH_ARGS)
    q_seg = torch.from_numpy(packed_segment_ids((90, 60), 200)[None]).cuda()
    kv_seg = torch.from_numpy(
        packed_segment_ids((100, 133), 333)[None]).cuda()
    kw = dict(scale=d ** -0.5)
    o, lse = flash.flash_fwd(q, k, v, q_seg, kv_seg, **kw)
    o_ref, lse_ref = flash.flash_fwd_reference(q, k, v, q_seg, kv_seg, **kw)
    torch.testing.assert_close(o, o_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    args = (q, k, v, o_ref, lse_ref, do, q_seg, kv_seg)
    torch.testing.assert_close(flash.flash_dq(*args, **kw),
                               flash.flash_dq_reference(*args, **kw),
                               atol=1e-4, rtol=1e-4)
    for got, want in zip(flash.flash_dkv(*args, **kw),
                         flash.flash_dkv_reference(*args, **kw)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", FLASH_MODES)
def test_flash_core_grads_match_autograd_of_plain_forward(mode):
    """FlashCore (kernel 4 forward, kernels 5 and 6 backward) against
    PyTorch autograd through the plain forward, f32 at 1e-4."""
    _need_card()
    t, d, b = 300, 64, 2
    case = flash_case(b, t, t, 2, d, seed=7)
    kw, (q_seg, kv_seg), seed = _flash_mode(mode, t, b)
    do = torch.from_numpy(case["do"]).cuda()
    leaves = [torch.from_numpy(case[x]).cuda().requires_grad_(True)
              for x in "qkv"]
    o = flash.FlashCore.apply(*leaves, q_seg, kv_seg, seed, d ** -0.5,
                              kw.get("causal", False), kw.get("kv_len"),
                              kw.get("dropout_rate", 0.0))
    o.backward(do)
    refs = [torch.from_numpy(case[x]).cuda().requires_grad_(True)
            for x in "qkv"]
    o_ref, _ = flash.flash_fwd_reference(*refs, q_seg, kv_seg, seed,
                                         scale=d ** -0.5, **kw)
    o_ref.backward(do)
    torch.testing.assert_close(o, o_ref, atol=1e-5, rtol=1e-5)
    for got, want in zip(leaves, refs):
        torch.testing.assert_close(got.grad, want.grad, atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("mode", FLASH_MODES)
def test_flash_core_bf16_grads_match_autograd_of_plain_forward(mode):
    """bf16 FlashCore (tensor-core kernels 4, 5 and 6) against PyTorch
    autograd through the plain forward in f32 on the same bf16 values:
    o, dq, dk and dv at 2e-2 absolute plus
    2e-2 relative (the kernels round p, ds, g and their outputs to
    bf16; autograd of the f32 forward rounds nothing)."""
    _need_card()
    t, d, b = 300, 64, 2
    case = flash_case(b, t, t, 2, d, seed=7)
    kw, (q_seg, kv_seg), seed = _flash_mode(mode, t, b)
    do = torch.from_numpy(case["do"]).cuda().bfloat16()
    leaves = [torch.from_numpy(case[x]).cuda().bfloat16().requires_grad_(True)
              for x in "qkv"]
    before = (flash.flash_fwd.launches, flash.flash_dq.launches,
              flash.flash_dkv.launches)
    o = flash.FlashCore.apply(*leaves, q_seg, kv_seg, seed, d ** -0.5,
                              kw.get("causal", False), kw.get("kv_len"),
                              kw.get("dropout_rate", 0.0))
    o.backward(do)
    assert (flash.flash_fwd.launches, flash.flash_dq.launches,
            flash.flash_dkv.launches) == tuple(n + 1 for n in before)
    refs = [x.detach().float().requires_grad_(True) for x in leaves]
    o_ref, _ = flash.flash_fwd_reference(*refs, q_seg, kv_seg, seed,
                                         scale=d ** -0.5, **kw)
    o_ref.backward(do.float())
    torch.testing.assert_close(o.float(), o_ref, atol=2e-2, rtol=2e-2)
    for got, want in zip(leaves, refs):
        assert got.grad.dtype == torch.bfloat16
        torch.testing.assert_close(got.grad.float(), want.grad, atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("d", [16, 40, 80])
def test_mha_sends_every_kernel_head_dim_to_flash(d):
    """`mha`'s gate on the card is what the kernels take (a multiple of 8
    up to 256), not JAX's multiple of 32: head dims 16, 40 and 80 launch
    kernel 4 and match the reference path."""
    _need_card()
    case = flash_case(2, 100, 100, 4, d, seed=d)
    q, k, v = (torch.from_numpy(case[x]).cuda() for x in "qkv")
    before = flash.flash_fwd.launches
    o = attention.mha(q, k, v, causal=True)
    assert flash.flash_fwd.launches == before + 1
    mask = flash.visible_pairs(2, 100, 100, True, None, device="cuda")
    want = attention.reference_attention(q, k, v, mask=mask)
    torch.testing.assert_close(o, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,d", [("float32", 64), ("bfloat16", 64),
                                     ("bfloat16", 128), ("bfloat16", 256)])
def test_flash_kernels_are_deterministic(dtype, d):
    """No atomics: two launches give the same bytes (bf16 at D 256 runs
    dq and dk/dv with the head dim split over two warpgroups)."""
    _need_card()
    dt = getattr(torch, dtype)
    case = flash_case(2, 300, 300, 4, d, seed=9)
    q, k, v, do = (torch.from_numpy(case[x]).cuda().to(dt)
                   for x in FLASH_ARGS)
    kw, (q_seg, kv_seg), seed = _flash_mode("dropout", 300, 2)
    kw["scale"] = 0.125
    o1, l1 = flash.flash_fwd(q, k, v, q_seg, kv_seg, seed, **kw)
    o2, l2 = flash.flash_fwd(q, k, v, q_seg, kv_seg, seed, **kw)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    args = (q, k, v, o1, l1, do, q_seg, kv_seg, seed)
    assert torch.equal(flash.flash_dq(*args, **kw),
                       flash.flash_dq(*args, **kw))
    (dk1, dv1), (dk2, dv2) = (flash.flash_dkv(*args, **kw),
                              flash.flash_dkv(*args, **kw))
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


def test_flash_rejects_what_it_cannot_take():
    _need_card()
    case = flash_case(1, 16, 16, 2, 32, seed=0)
    q, k, v, _ = (torch.from_numpy(case[x]).cuda() for x in FLASH_ARGS)
    kw = dict(scale=0.1)
    with pytest.raises(TypeError, match="not supported"):
        flash.flash_fwd(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(TypeError, match="one dtype"):
        flash.flash_fwd(q, k.bfloat16(), v, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                        v, **kw)
    odd = flash_case(1, 16, 16, 2, 12, seed=0)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash.flash_fwd(*(torch.from_numpy(odd[x]).cuda() for x in "qkv"),
                        **kw)


def _tiny_lm(device, num_kv_heads=None):
    dims = dict(model_dim=64, num_heads=2, num_layers=2, ffn_dim=128)
    model = CausalLM(97, dropout=0.0, max_len=64, device=device,
                     num_kv_heads=num_kv_heads, **dims)
    load_jax_params(model, causal_lm_tree(0, 97, num_kv_heads=num_kv_heads,
                                          **dims))
    return model


def _lm_loss(module, batch, generator, training):
    inp, tgt = batch
    hid = module(inp, return_hidden=True, generator=generator)
    w, bias = module.head_weights()
    return linear_cross_entropy(hid, w, tgt, bias, chunk=256).mean(), {}


@pytest.mark.parametrize("kv_heads", [None, 1])
def test_train_step_on_card_matches_cpu(kv_heads):
    """One f32 Trainer step on the card (flash kernels, one launch of
    each per layer) against the same step on the CPU (plain attention):
    loss within 1e-4, gradients within 1e-4 of each tensor's scale."""
    _need_card()
    batch = lm_stream(np.random.default_rng(0), 2, 48, 97)
    steps = {}
    for dev in ("cpu", "cuda"):
        model = _tiny_lm(dev, num_kv_heads=kv_heads)
        tr = Trainer(model, Adam(model.parameters(), 1e-3), _lm_loss)
        before = (flash.flash_fwd.launches, flash.flash_dq.launches,
                  flash.flash_dkv.launches)
        out = tr.train_step(tuple(torch.from_numpy(x).to(dev)
                                  for x in batch))
        after = (flash.flash_fwd.launches, flash.flash_dq.launches,
                 flash.flash_dkv.launches)
        want = 2 if dev == "cuda" else 0
        assert tuple(a - b for a, b in zip(after, before)) == (want,) * 3
        steps[dev] = (float(out["loss"]),
                      {n: p.grad.detach().cpu()
                       for n, p in model.named_parameters()})
    np.testing.assert_allclose(steps["cuda"][0], steps["cpu"][0],
                               rtol=1e-4, atol=1e-4)
    for name, g in steps["cpu"][1].items():
        scale = float(g.abs().max())
        torch.testing.assert_close(steps["cuda"][1][name], g, rtol=1e-4,
                                   atol=1e-4 * scale + 1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_guarded_nan_burst_on_card_equals_clean_run(tmp_path, monkeypatch,
                                                    dtype):
    """`train_resilient` over a guarded MeshTrainer on the card: a NaN
    burst at steps 2-3 (the float per-token weights poisoned) leaves
    the loss curve and every state leaf bit-equal to a clean run; the
    flash kernels launch once a layer on every attempt, the skipped
    ones included."""
    _need_card()
    from paddle_tpu_torch.io import CheckpointManager
    from paddle_tpu_torch.parallel import DistStrategy, MeshTrainer
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.resilience.supervisor import train_resilient
    from paddle_tpu_torch.utils.tree import flatten_with_keys

    monkeypatch.setenv("PTPU_RETRY_SCALE", "0")
    dims = dict(model_dim=64, num_heads=2, num_layers=2, ffn_dim=128)
    toks = [lm_stream(np.random.default_rng(s), 2, 48, 97) for s in range(5)]

    def batch_for(step):
        inp, tgt = (torch.from_numpy(x).cuda() for x in toks[step])
        return inp, tgt, torch.ones(inp.shape, device="cuda")

    def loss_fn(module, batch, generator, training):
        inp, tgt, w = batch
        hid = module(inp, return_hidden=True, generator=generator)
        wt, bias = module.head_weights()
        per = linear_cross_entropy(
            hid, wt.to(hid.dtype), tgt,
            None if bias is None else bias.to(hid.dtype), chunk=256)
        return (per * w).sum() / w.sum(), {}

    runs = []
    for name, nan in (("clean", None), ("burst", "2:3")):
        if nan is None:
            monkeypatch.delenv("PTPU_CHAOS_NAN_STEP", raising=False)
        else:
            monkeypatch.setenv("PTPU_CHAOS_NAN_STEP", nan)
        chaos.reset()
        model = CausalLM(97, dropout=0.0, max_len=64, device="cuda",
                         dtype=dtype, **dims)
        load_jax_params(model, causal_lm_tree(0, 97, **dims))
        trainer = MeshTrainer(model, Adam(model.parameters(), 1e-3), loss_fn,
                              strategy=DistStrategy(bad_step_budget=2))
        before = flash.flash_fwd.launches
        losses = {}
        train_resilient(trainer, batch_for, 5,
                        CheckpointManager(str(tmp_path / name)),
                        on_step=lambda s, f, _l=losses: _l.__setitem__(
                            s, float(f["loss"])))
        attempts = 5 + (2 if nan else 0)
        assert flash.flash_fwd.launches - before == attempts * 2
        runs.append((losses, {k: v.detach().clone() for k, v in
                              flatten_with_keys(trainer.state())}))
    chaos.reset()
    (clean, want), (burst, got) = runs
    assert burst == clean and sorted(clean) == [0, 1, 2, 3, 4]
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_replica_on_card_streams_through_the_graph():
    """An in-process port replica on the card (the CLI's default
    device): one SSE completion streams to [DONE] with the tokens a
    direct engine on the same seeded weights gives, the scrape reads
    `ptpu_engine_compiles` 1, the engine holds its one captured graph,
    and kernel 1 launched once a layer a step."""
    _need_card()
    from paddle_tpu_torch.serve import replica
    from paddle_tpu_torch.serve.sse import (collect_stream, http_get,
                                            parse_prometheus_values)

    # the CLI's default dims have head dim 4; the kernel takes multiples
    # of 8
    a = replica.build_parser().parse_args(
        ["--port", "0", "--model-dim", "32", "--num-heads", "4"])
    fe = replica.build_frontend(a)
    assert fe.engine.device.type == "cuda"
    before = paged.ragged_paged_attention.launches
    fe.start()
    try:
        out = collect_stream(fe.url, {"prompt": [5, 9, 2, 7],
                                      "max_new_tokens": 8})
        assert out["status"] == 200 and out["done"]
        vals = parse_prometheus_values(http_get(fe.url + "/metrics")[1])
        assert vals["ptpu_engine_compiles"] == 1.0
        assert len(fe.engine.step_graph.graphs) == 1
        # warm-up steps were zeroed by the reset; count them back in
        launched = paged.ragged_paged_attention.launches - before
        assert launched % a.num_layers == 0 and launched > 0
    finally:
        fe.stop()
    direct = ServeEngine(replica.seeded_causal_lm(a, torch.device("cuda")),
                         registry=MetricsRegistry(), max_batch_size=4,
                         block_size=4, num_blocks=64, max_prefill_tokens=64)
    assert out["tokens"] == direct.generate([[5, 9, 2, 7]],
                                            max_new_tokens=8)[0]


# -- the encoder models on the card -------------------------------------------

def _plain_flash(monkeypatch):
    """FlashCore through the kernels' plain versions (on card tensors)."""
    monkeypatch.setattr(flash, "flash_fwd", flash.flash_fwd_reference)
    monkeypatch.setattr(flash, "flash_dq", flash.flash_dq_reference)
    monkeypatch.setattr(flash, "flash_dkv", flash.flash_dkv_reference)


def _encoder_run(layer, x, segs, gen_seed=0):
    layer.zero_grad(set_to_none=True)
    x = x.detach().clone().requires_grad_(True)
    out = layer(x, segment_ids=segs)
    g = torch.Generator(device="cuda").manual_seed(gen_seed)
    do = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
    out.backward(do)
    return out.detach(), x.grad.detach(), {
        n: p.grad.detach().clone() for n, p in layer.named_parameters()}


def _norm_gap(got, want):
    """|got - want| over |want|, in norm."""
    g, w = got.float(), want.float()
    return float((g - w).norm()) / max(float(w.norm()), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_layer_kernels_match_plain(dtype, monkeypatch):
    """A BERT-base EncoderLayer (d 768, 12 heads of 64) forward and
    backward on a padded batch (segment ids from lengths, non-causal):
    kernels 4, 5 and 6 each launch once, and the output, the input's
    gradient and every parameter's gradient match the same layer through
    the kernels' plain versions, in norm. A control run through `mha`'s
    dense path (no flash code) measures the dtype's own spread against
    the plain run: each tensor's gap must stay within 1e-4 of its norm
    in f32 (2e-2 in bf16) or within twice the control's gap. The second
    clause covers what float noise alone decides: the key bias's
    gradient, 0 in exact arithmetic (softmax ignores a per-row shift),
    and in bf16 the sums the layer rounds after attention (~2% of a
    norm). A kernel fault moves a tensor by O(1) and the control not."""
    _need_card()
    from paddle_tpu_torch.models import EncoderLayer
    from paddle_tpu_torch.ops.sequence import sequence_mask
    dt = getattr(torch, dtype)
    torch.manual_seed(0)
    layer = EncoderLayer(768, 12, 3072, dropout=0.0, dtype=dt,
                         device="cuda")
    x = torch.randn(2, 128, 768, device="cuda").to(dt)
    segs = sequence_mask(torch.tensor([128, 77], device="cuda"),
                         128).to(torch.int32)
    before = [f.launches for f in (flash.flash_fwd, flash.flash_dq,
                                   flash.flash_dkv)]
    got = _encoder_run(layer, x, segs)
    assert [f.launches for f in (flash.flash_fwd, flash.flash_dq,
                                 flash.flash_dkv)] == [n + 1 for n in before]
    _plain_flash(monkeypatch)
    want = _encoder_run(layer, x, segs)
    monkeypatch.setattr(attention, "would_use_flash",
                        lambda *args, **kwargs: False)
    dense = _encoder_run(layer, x, segs)
    bar = 1e-4 if dtype == "float32" else 2e-2

    def gaps(run):
        out = {"out": _norm_gap(run[0], want[0]),
               "dx": _norm_gap(run[1], want[1])}
        out.update({n: _norm_gap(run[2][n], w) for n, w in want[2].items()})
        return out
    kernel_gaps, control_gaps = gaps(got), gaps(dense)
    bad = {n: (g, control_gaps[n]) for n, g in kernel_gaps.items()
           if not g <= max(bar, 2.0 * control_gaps[n])}
    assert not bad, (bad, kernel_gaps, control_gaps)


def test_cross_attention_without_a_mask_takes_kernel_4():
    """The Transformer's cross-attention without src_lengths (no mask)
    goes to kernel 4 with Tq != Tk, and matches the dense reference."""
    _need_card()
    from paddle_tpu_torch.models import MultiHeadAttention
    torch.manual_seed(1)
    for fused in (False, True):
        mha_ = MultiHeadAttention(512, 8, dropout=0.0, fused_qkv=fused,
                                  device="cuda", cross=True)
        q = torch.randn(2, 37, 512, device="cuda")
        memory = torch.randn(2, 211, 512, device="cuda")
        before = flash.flash_fwd.launches
        with torch.no_grad():
            out = mha_(q, kv=memory, causal=False)
            assert flash.flash_fwd.launches == before + 1
            qh, kh, vh = mha_._project_cross(q, memory)
            want = mha_.out_proj(attention.reference_attention(
                qh, kh, vh).reshape(2, 37, 512))
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


def test_transformer_decode_step_paged_matches_decode_step_on_card():
    """Transformer.decode_step_paged (kernel 3, one launch per decoder
    layer a step) gives decode_step's logits (the dense path) on the
    card, f32, with shuffled block tables."""
    _need_card()
    from paddle_tpu_torch.models import Transformer
    from paddle_tpu_torch.testing import transformer_tree
    v, b, steps, bs = 61, 3, 9, 4
    model = load_jax_params(
        Transformer(v, v, 64, 8, 2, 128, dropout=0.0, max_len=32,
                    device="cuda"),
        transformer_tree(3, v, v, 64, 8, 2, 128, random_norms=True))
    rs = np.random.RandomState(0)
    src = torch.from_numpy(rs.randint(3, v, (b, 11))).cuda()
    trg = torch.from_numpy(rs.randint(3, v, (b, steps))).cuda()
    lens = torch.tensor([11, 6, 9], device="cuda")
    mb = -(-steps // bs)
    tables = torch.from_numpy(rs.permutation(np.arange(1, 1 + b * mb))
                              .reshape(b, mb).astype(np.int32)).cuda()
    pools = [(torch.zeros(1 + b * mb, bs, 8, 8, device="cuda"),
              torch.zeros(1 + b * mb, bs, 8, 8, device="cuda"))
             for _ in range(2)]
    with torch.no_grad():
        memory, src_mask = model.encode(src, lens)
        caches = model.init_cache(b, max_len=steps)
        before = paged.paged_attention.launches
        for t in range(steps):
            dense, caches = model.decode_step(trg[:, t], t, memory, caches,
                                              src_mask)
            pos = torch.full((b,), t, dtype=torch.int32, device="cuda")
            slots = tables[:, t // bs].long() * bs + t % bs
            got = model.decode_step_paged(trg[:, t], pos, memory, pools,
                                          tables, pos + 1, slots, src_mask)
            torch.testing.assert_close(got, dense, atol=1e-4, rtol=1e-4)
        assert paged.paged_attention.launches == before + steps * 2
