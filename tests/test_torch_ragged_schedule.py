"""The ragged kernels' schedule helpers (pure Python, no card) against
hand counts, and a CPU rehearsal of chip_smoke.py.

The CUDA kernels (csrc/ragged_tc.cuh) split a row's kv axis at fixed
positions: C positions an iteration, S a split, both anchored at position
0 and depending on the dtype and head dim only. The wrappers of the
ragged calls and of the decode call (one tile a sequence) size the split
kernel's grid, its shared memory and the partials' workspace from these
helpers; the card's tests hold the shared-memory count to the library's
own.
"""

import io
import itertools
import json
import logging
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.kernels import paged_attention as paged

CARD_SMEM = 232448
ROWS = (1, 4, 8, 16, 32, 64, 256)
BLOCK_SIZES = (1, 4, 16, 64)


@pytest.mark.parametrize("max_blocks,block_size,want", [
    (128, 16, 8),     # the LM's max_len 2048 in blocks of 16
    (16, 16, 1),      # 256 positions: one split
    (17, 16, 2),      # one block past it
    (45, 16, 3),      # 720 positions
    (1, 1, 1),
    (64, 4, 1),
    (65, 4, 2),
    (33, 8, 2),       # 264 positions
])
def test_num_splits_by_hand(max_blocks, block_size, want):
    assert paged.ragged_num_splits(max_blocks, block_size) == want


def test_workspace_shape_by_hand():
    # phase_kernel_time's shape: 72 tiles, 8 kv heads, 8 splits, tile_q 8
    # x G 1 query rows, head dim 64: acc [64], then m and l
    assert paged.ragged_workspace_shape(72, 8, 8, 8, 64) == (72, 8, 8, 8, 66)
    assert paged.ragged_workspace_shape(3, 2, 1, 32, 256) == (3, 2, 1, 32, 258)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", range(8, 257, 8))
def test_chunk_and_split_per_dtype_and_head_dim(dtype, head_dim):
    """C = 64 (f32 above head dim 128: 32), S = 256, whatever the tile's
    rows and the block size; every schedule fits one CTA's shared memory
    on the card."""
    want_chunk = 32 if dtype == torch.float32 and head_dim > 128 else 64
    for rows, bs in itertools.product(ROWS, BLOCK_SIZES):
        sched = paged.ragged_schedule(dtype, head_dim, rows, bs)
        assert (sched.chunk, sched.split) == (want_chunk, 256)
        assert sched.split % sched.chunk == 0
        assert sched.chunk % paged.RAGGED_LANES == 0
        assert sched.threads == sched.chunk // paged.RAGGED_LANES * 32
        assert sched.smem_bytes <= CARD_SMEM
        assert sched.row_groups * sched.warp_rows >= rows
        assert (sched.row_groups - 1) * sched.warp_rows < rows


def test_smem_by_hand_at_the_lm_shape():
    """Head dim 64, tile_q 8 x G 1, blocks of 16: the ring's stages (bf16
    2, f32 1) of C = 64 K and V rows, the CTA's q rows, and three
    16-byte-rounded arrays of the 17 table entries and scales a split of
    256 positions spans."""
    assert paged.ragged_split_blocks(256, 16) == 17
    assert paged.ragged_split_blocks(256, 1) == 257
    table = 3 * 80
    # bf16: rows of (64 + 8) * 2 bytes, 16 q rows
    bf16 = paged.ragged_schedule(torch.bfloat16, 64, 8, 16)
    assert bf16.smem_bytes == (2 * 2 * 64 + 16) * 144 + table
    # f32: rows of (64 + 4) * 4 bytes, 8 q rows
    f32 = paged.ragged_schedule(torch.float32, 64, 8, 16)
    assert f32.smem_bytes == (1 * 2 * 64 + 8) * 272 + table


def test_shared_memory_bytes_needs_no_library():
    """The wrapper's count (cached per shape) is pure Python, so the CPU
    can report it."""
    for bs in BLOCK_SIZES:
        assert (paged.shared_memory_bytes(8, 1, 64, bs, dtype=torch.bfloat16)
                == paged.ragged_schedule(torch.bfloat16, 64, 8,
                                         bs).smem_bytes)


@pytest.mark.parametrize("dtype,hkv,head_dim,max_blocks,splits,smem", [
    # phase_kernel_time's decode call: 8 rows, H 8 MHA, D 64, tables of
    # the LM's 128 blocks of 16 = 2048 positions, 8 splits of 256
    (torch.float32, 8, 64, 128, 8, (1 * 2 * 64 + 8) * 272 + 3 * 80),
    (torch.bfloat16, 8, 64, 128, 8, (2 * 2 * 64 + 16) * 144 + 3 * 80),
    # split_path's: tables of 3 blocks, one split, no workspace
    (torch.float32, 8, 64, 3, 1, (1 * 2 * 64 + 8) * 272 + 3 * 80),
    # GQA 8:2 at D 128 (bf16 rows (128 + 8) * 2 bytes)
    (torch.bfloat16, 2, 128, 17, 2, (2 * 2 * 64 + 16) * 272 + 3 * 80),
])
def test_decode_plan_by_hand(dtype, hkv, head_dim, max_blocks, splits,
                             smem, monkeypatch):
    """The decode call (one tile a sequence, tile_q 1, its G query heads
    as the tile's rows) takes kernel 1's schedule: its splits, its f32
    partials [B, Hkv, splits, G, D + 2] (none with one split) and a CTA's
    shared memory, by hand and with no library to ask."""
    def no_library(name):
        raise AssertionError(f"library {name} loaded")
    monkeypatch.setattr(paged.build, "load", no_library)
    g = 8 // hkv
    plan = paged.ragged_plan(dtype, 8, 1, 8, hkv, head_dim, 16, max_blocks)
    assert plan.splits == splits
    assert plan.workspace == (None if splits == 1 else
                              (8, hkv, splits, g, head_dim + 2))
    assert plan.schedule == paged.ragged_schedule(dtype, head_dim, g, 16)
    assert plan.schedule.row_groups == 1
    assert plan.schedule.smem_bytes == smem
    assert paged.shared_memory_bytes(1, g, head_dim, 16, "paged_attention",
                                     dtype) == smem


def test_ragged_plan_at_the_engine_shape():
    """phase_kernel_time's ragged call: 72 tiles of tile_q 8 x G 1 over
    tables of 128 blocks of 16."""
    plan = paged.ragged_plan(torch.bfloat16, 72, 8, 8, 8, 64, 16, 128)
    assert plan.splits == 8
    assert plan.workspace == (72, 8, 8, 8, 66)
    assert plan.schedule == paged.ragged_schedule(torch.bfloat16, 64, 8, 16)


def test_shared_memory_bytes_names_its_kernel():
    for kernel in ("ragged_paged_attention", "paged_attention"):
        assert paged.shared_memory_bytes(1, 4, 64, 16, kernel) == \
            paged.ragged_schedule(torch.float32, 64, 4, 16).smem_bytes
    with pytest.raises(ValueError, match="no kernel"):
        paged.shared_memory_bytes(1, 4, 64, 16, "paged_decode")


def test_chip_smoke_rehearses_on_the_cpu():
    """`chip_smoke.py --tiny` runs every phase with the plain versions and
    ends with the rehearsal's `ok` line; the kernel_time lines of kernels
    1-3 carry the device-clock fields, null without a card."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    serve_log = logging.getLogger("paddle_tpu_torch.serve")
    disabled = serve_log.disabled
    buf = io.StringIO()
    try:
        with torch.random.fork_rng(), redirect_stdout(buf):
            assert chip_smoke.main(["--tiny"]) == 0
    finally:
        serve_log.disabled = disabled
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    assert lines[-1] == {"ok": True, "rehearsal": True,
                         "device": {"platform": "cpu", "kind": "cpu",
                                    "count": 0}}
    assert [r["name"] for r in lines[-2]["kernels"]][:3] == [
        "ragged_paged_attention", "ragged_paged_attention_mixed",
        "paged_attention"]
    timed = {(x["kernel"], x.get("dtype")): x for x in lines
             if x.get("phase") == "kernel_time"}
    for name in ("ragged_paged_attention", "ragged_paged_attention_mixed",
                 "paged_attention"):
        rows = [x for (k, _), x in timed.items() if k == name]
        assert rows, name
        for x in rows:
            assert x["device_ms"] is None and x["host_enqueue_ms"] is None
            assert x["split_ms"] is None and x["combine_ms"] is None
            assert x["clock"] == "not measured (no card)"
            assert x["ms"] == x["events_ms"] > 0
    # kernel 3 against kernel 1 on the same decode rows: reported here,
    # held to equal bits on the card
    against = [x for x in lines if x.get("phase") == "kernel_vs_plain"
               and x.get("against")]
    assert len(against) == 4
    assert all(x["kernel"] == "paged_attention" for x in against)
