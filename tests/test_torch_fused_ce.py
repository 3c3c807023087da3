"""The port's chunked linear cross-entropy against the JAX package's
(tests of tests/test_fused_ce.py's kind, on both sides): the loss and
the gradients wrt h, w and b, with ignore_index rows, a vocabulary that
does not divide the chunk, leading dims and no bias. Inputs come from a
numpy seed. Bars: float32 within 1e-5 (absolute and relative); bf16
within 2e-3, since both sides round h, w and the backward's dl to bf16
and then differ only in float32 summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused_ce import linear_cross_entropy as jax_lce
from paddle_tpu_torch.ops.fused_ce import (DEFAULT_CHUNK, effective_chunk,
                                           linear_cross_entropy)

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-3, rtol=2e-3)


def _case(seed, n, d, v, bias=True, lead=None):
    rs = np.random.RandomState(seed)
    shape = lead if lead is not None else (n,)
    h = rs.randn(*shape, d).astype(np.float32)
    w = (rs.randn(d, v) * 0.1).astype(np.float32)
    b = (rs.randn(v) * 0.1).astype(np.float32) if bias else None
    labels = rs.randint(0, v, shape).astype(np.int32)
    gw = rs.rand(*shape).astype(np.float32)   # per-row upstream weight
    return h, w, b, labels, gw


def _both(h, w, b, labels, gw, chunk, dtype=np.float32, **kw):
    """(loss, grads) of sum(gw * lce) from JAX and from the port, in
    float32 numpy; grads in the order h, w[, b]."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    argnums = (0, 1, 2) if b is not None else (0, 1)

    def jloss(h_, w_, *b_):
        return jax_lce(h_, w_, jnp.asarray(labels), b_[0] if b_ else None,
                       chunk=chunk, **kw)

    jargs = [jnp.asarray(x, jdt) for x in (h, w)] + (
        [jnp.asarray(b, jdt)] if b is not None else [])
    jl = np.asarray(jloss(*jargs), np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jnp.asarray(gw) * jloss(*a)),
                  argnums=argnums)(*jargs)
    targs = [torch.tensor(x).to(tdt).requires_grad_(True)
             for x in ([h, w] + ([b] if b is not None else []))]
    tl = linear_cross_entropy(targs[0], targs[1], torch.from_numpy(labels),
                              targs[2] if b is not None else None,
                              chunk=chunk, **kw)
    (torch.from_numpy(gw) * tl).sum().backward()
    return (jl, [np.asarray(g, np.float32) for g in jg],
            tl.detach().numpy(), [t.grad.float().numpy() for t in targs])


@pytest.mark.parametrize("v,chunk", [(64, 256), (1000, 256), (512, 128),
                                     (700, 256)])
def test_loss_and_grads_match_jax(v, chunk):
    jl, jg, tl, tg = _both(*_case(0, 33, 24, v), chunk)
    np.testing.assert_allclose(tl, jl, **F32)
    for name, a, b in zip("hwb", tg, jg):
        np.testing.assert_allclose(a, b, err_msg=f"grad wrt {name}", **F32)


def test_ignore_index_rows_zero_loss_and_grad():
    h, w, _, labels, gw = _case(1, 16, 8, 300, bias=False)
    labels[::3] = -100
    jl, jg, tl, tg = _both(h, w, None, labels, gw, 128)
    assert np.all(tl[::3] == 0.0) and np.all(tg[0][::3] == 0.0)
    assert np.any(tg[0][1] != 0.0)
    np.testing.assert_allclose(tl, jl, **F32)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **F32)


def test_other_ignore_index():
    h, w, b, labels, gw = _case(2, 12, 8, 90)
    labels[1::4] = 7
    jl, jg, tl, tg = _both(h, w, b, labels, gw, 64, ignore_index=7)
    assert np.all(tl[1::4] == 0.0)
    np.testing.assert_allclose(tl, jl, **F32)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a, b_, **F32)


def test_leading_dims_and_no_bias():
    jl, jg, tl, tg = _both(*_case(3, None, 8, 120, bias=False,
                                  lead=(3, 5)), 64)
    assert tl.shape == (3, 5)
    np.testing.assert_allclose(tl, jl, **F32)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **F32)


def test_bf16_matches_jax_bf16():
    jl, jg, tl, tg = _both(*_case(4, 64, 32, 520), 256, dtype="bf16")
    np.testing.assert_allclose(tl, jl, **BF16)
    for name, a, b in zip("hwb", tg, jg):
        np.testing.assert_allclose(a, b, err_msg=f"grad wrt {name}", **BF16)


def test_effective_chunk():
    assert effective_chunk(32000) == DEFAULT_CHUNK == 8192
    assert effective_chunk(1000, 8192) == 1024
    assert effective_chunk(64, 256) == 256
    assert effective_chunk(700, 128) == 128


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="leading dims"):
        linear_cross_entropy(torch.zeros(4, 8), torch.zeros(8, 10),
                             torch.zeros(5, dtype=torch.long))
