"""The port's ragged paged attention against the JAX package's.

The same numpy inputs go through JAX's `ragged_paged_attention_reference`
(the XLA oracle), JAX's Pallas kernel in interpret mode, and the port's
`ragged_paged_attention` on CPU tensors (its plain PyTorch version).
f32 agreement is held at atol/rtol 1e-5, the bar the Pallas kernel met
against its own oracle (2.4e-7 measured). The CUDA kernel itself runs
only on the card: tests/test_torch_kernels_gpu.py holds it against this
plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jax_paged
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import paged_attention as paged
from paddle_tpu_torch.testing import RAGGED_ARGS, ragged_case

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = {
    # name: (rows [(context_len, q_len)], H, Hkv, D, block_size, tile_q)
    "decode_only": ([(5, 1), (8, 1), (1, 1), (13, 1)], 4, 4, 8, 4, 4),
    "chunk_only": ([(9, 9), (13, 5), (11, 3)], 4, 4, 8, 4, 4),
    "mixed": ([(7, 1), (10, 6), (4, 4), (17, 2)], 4, 4, 8, 4, 4),
    "gqa": ([(7, 3), (11, 1), (6, 6)], 8, 2, 16, 4, 4),
    "mqa": ([(12, 5), (3, 1)], 4, 1, 8, 8, 4),
    "block_aligned": ([(16, 16), (8, 4), (12, 1)], 4, 4, 8, 4, 8),
    "tile_q_1": ([(7, 1), (10, 6), (9, 9)], 4, 2, 8, 4, 1),
    "tile_q_4": ([(7, 1), (10, 6), (9, 9)], 4, 2, 8, 4, 4),
    "tile_q_8": ([(7, 1), (10, 6), (9, 9)], 4, 2, 8, 4, 8),
}


def _case(name, pad_tiles=2, seed=0):
    rows, h, hkv, d, bs, tq = CASES[name]
    return ragged_case(rows, h, hkv, d, bs, tq, pad_tiles=pad_tiles,
                       seed=seed)


def _port(case, **kw):
    out = paged.ragged_paged_attention(
        *[torch.from_numpy(case[k]) for k in RAGGED_ARGS], **kw)
    return out.numpy()


def _jax(case, **kw):
    fn = (jax_paged.ragged_paged_attention if kw
          else jax_paged.ragged_paged_attention_reference)
    return np.asarray(fn(*[jnp.asarray(case[k]) for k in RAGGED_ARGS],
                         **kw))


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_reference(name):
    case = _case(name)
    np.testing.assert_allclose(_port(case), _jax(case), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_pallas_kernel_interpret(name):
    case = _case(name)
    want = _jax(case, use_kernel=True, interpret=True)
    got = _port(case)
    assert np.isfinite(got).all()        # pad queries/tiles stay finite
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_version_is_what_cpu_tensors_get():
    case = _case("mixed")
    ts = [torch.from_numpy(case[k]) for k in RAGGED_ARGS]
    before = paged.ragged_paged_attention.launches
    got = paged.ragged_paged_attention(*ts)
    assert paged.ragged_paged_attention.launches == before   # no kernel
    want = paged.ragged_paged_attention_reference(*ts)
    assert torch.equal(got, want)


def test_pad_tiles_are_inert():
    """Extra pad tiles on the null row leave the real segments
    bit-identical (the engine's fixed-width step relies on it)."""
    tq = CASES["mixed"][5]
    b = _case("mixed", pad_tiles=4)
    a = dict(b, q=b["q"][:-3 * tq], tile_rows=b["tile_rows"][:-3],
             tile_offs=b["tile_offs"][:-3])
    ga, gb = _port(a), _port(b)
    n = ga.shape[0] - tq
    np.testing.assert_array_equal(ga[:n], gb[:n])


def test_explicit_scale_matches_jax():
    case = _case("gqa")
    np.testing.assert_allclose(_port(case, scale=0.3),
                               _jax(case, use_kernel=False, scale=0.3),
                               **TOL)


def test_bfloat16_inputs_match_f32_plain_on_same_values():
    """bf16 operands: the port computes in the pool dtype with f32
    softmax; held against the f32 plain version on the same bf16
    values at the bf16 tolerance chip_smoke.py uses (2e-2)."""
    case = _case("mixed")
    ts = [torch.from_numpy(case[k]) for k in RAGGED_ARGS]
    ts16 = [t.bfloat16() if t.is_floating_point() else t for t in ts]
    got = paged.ragged_paged_attention(*ts16)
    assert got.dtype == torch.bfloat16
    want = paged.ragged_paged_attention_reference(
        *[t.float() if t.is_floating_point() else t for t in ts16])
    assert float((got.float() - want).abs().max()) <= 2e-2


def test_operand_checks_raise():
    case = _case("mixed")
    ts = [torch.from_numpy(case[k]) for k in RAGGED_ARGS]
    bad_t = list(ts)
    bad_t[0] = ts[0][:-1]                 # T not a multiple of tiles
    with pytest.raises(ValueError, match="multiple"):
        paged.ragged_paged_attention(*bad_t)
    bad_h = list(ts)
    bad_h[0] = torch.zeros(ts[0].shape[0], 3, ts[0].shape[2])
    with pytest.raises(ValueError, match="multiple of kv heads"):
        paged.ragged_paged_attention(*bad_h)
    oob = list(ts)
    oob[3] = ts[3].clone()
    oob[3][0, 0] = ts[1].shape[0]         # one past the pool
    with pytest.raises(ValueError, match="outside the pool"):
        paged.ragged_paged_attention(*oob, check_block_ids=True)


def test_build_covers_every_cuda_source():
    """build_all() (what chip_smoke.py runs) builds every source under
    kernels/csrc/, each into a library named by a hash of its bytes."""
    assert set(build.SOURCES.values()) == {
        p.name for p in build.CSRC.glob("*.cu")}
    for name in build.SOURCES:
        path = build._lib_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
