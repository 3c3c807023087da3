"""The port's flash attention against the JAX package's (tests of
tests/test_flash_segments.py's kind, on both sides).

On the CPU the port's `flash_attention` runs the plain versions of its
three kernels (forward, dq, dk/dv); JAX runs its Pallas kernels in
interpret mode with 16 x 16 blocks, as its own tests do. Inputs come
from a numpy seed. Bars: float32 o within 1e-5 and gradients within
1e-4 (absolute and relative): the two sides sum in different orders
(JAX per 16-block online softmax, the plain version densely).

Dropout is compared at the core level, with the seed passed on both
sides (JAX's `_flash_core` is given [[seed]]), since JAX draws the seed
from its own rng; the hash itself is held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import attention as jattn
from paddle_tpu.kernels import flash as jflash
from paddle_tpu_torch.kernels import attention as tattn
from paddle_tpu_torch.kernels import flash as tflash

O_TOL = dict(atol=1e-5, rtol=1e-5)
G_TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def _packed_segs(lengths, t):
    """One row of segment ids: consecutive documents of `lengths`, the
    tail (if any) its own segment."""
    ids = np.full((t,), len(lengths), dtype=np.int32)
    pos = 0
    for i, n in enumerate(lengths):
        ids[pos:pos + n] = i
        pos += n
    return ids


def _jax_fwd_vjp(fn, q, k, v, do):
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_fwd_vjp(fn, q, k, v, do):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = fn(*ts)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _hold(jax_fn, port_fn, q, k, v, seed=0):
    do = _rand(np.random.default_rng(seed + 100), *q.shape)
    jo, jg = _jax_fwd_vjp(jax_fn, q, k, v, do)
    to, tg = _port_fwd_vjp(port_fn, q, k, v, do)
    np.testing.assert_allclose(to, jo, **O_TOL)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **G_TOL)
    return to, tg


def _wrapper_pair(**kw):
    """JAX flash_attention (interpret, 16 x 16 blocks) and the port's,
    with the same keyword arguments."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else
               tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
               else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
               tuple(torch.from_numpy(x) for x in v)
               if isinstance(v, tuple) else v) for k, v in kw.items()}

    def jax_fn(q, k, v):
        return jflash.flash_attention(q, k, v, block_q=16, block_k=16,
                                      interpret=True, **jkw)

    def port_fn(q, k, v):
        return tflash.flash_attention(q, k, v, **tkw)
    return jax_fn, port_fn


CASES = {
    # name: (B, Tq, Tk, H, D, kwargs)
    "full": (2, 48, 48, 2, 16, dict()),
    "causal": (2, 48, 48, 2, 32, dict(causal=True)),
    "kv_len": (1, 40, 40, 2, 16, dict(kv_len=29)),
    "kv_len_causal": (2, 40, 40, 1, 16, dict(causal=True, kv_len=33)),
    "ragged_tail_causal": (1, 50, 50, 2, 16, dict(causal=True)),
    "ragged_tail_full": (2, 37, 37, 1, 32, dict()),
    "cross_lengths": (1, 24, 56, 2, 16, dict()),
    "single_query": (2, 1, 1, 2, 16, dict(causal=True)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_grads_match_jax(name):
    b, tq, tk, h, d, kw = CASES[name]
    rs = np.random.default_rng(sorted(CASES).index(name))
    q, k, v = _rand(rs, b, tq, h, d), _rand(rs, b, tk, h, d), \
        _rand(rs, b, tk, h, d)
    _hold(*_wrapper_pair(**kw), q, k, v)


@pytest.mark.parametrize("causal", [False, True])
def test_segments_self_match_jax(causal):
    b, t, h, d = 2, 64, 2, 16
    rs = np.random.default_rng(7)
    q, k, v = (_rand(rs, b, t, h, d) for _ in range(3))
    segs = np.stack([_packed_segs((25, 30), t), _packed_segs((40, 20), t)])
    _hold(*_wrapper_pair(causal=causal, segment_ids=segs), q, k, v)


def test_segments_pair_match_jax():
    b, tq, tk, h, d = 1, 48, 64, 2, 16
    rs = np.random.default_rng(8)
    q = _rand(rs, b, tq, h, d)
    k, v = _rand(rs, b, tk, h, d), _rand(rs, b, tk, h, d)
    q_seg = _packed_segs((20, 28), tq)[None]
    kv_seg = _packed_segs((33, 31), tk)[None]
    _hold(*_wrapper_pair(segment_ids=(q_seg, kv_seg)), q, k, v)


def test_segments_ragged_tail_match_jax():
    b, t, h, d = 1, 50, 1, 16
    rs = np.random.default_rng(9)
    q, k, v = (_rand(rs, b, t, h, d) for _ in range(3))
    segs = _packed_segs((30, 20), t)[None]
    _hold(*_wrapper_pair(causal=True, segment_ids=segs), q, k, v)


def test_packed_equals_separate():
    """Two documents packed with segment ids == each run alone."""
    b, h, d, n1, n2 = 1, 2, 16, 24, 40
    rs = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(_rand(rs, b, n1 + n2, h, d))
               for _ in range(3))
    segs = torch.from_numpy(_packed_segs((n1, n2), n1 + n2)[None])
    packed = tflash.flash_attention(q, k, v, causal=True, segment_ids=segs)
    for sl in (slice(0, n1), slice(n1, n1 + n2)):
        solo = tflash.flash_attention(q[:, sl], k[:, sl], v[:, sl],
                                      causal=True)
        torch.testing.assert_close(packed[:, sl], solo, **O_TOL)


@pytest.mark.parametrize("kw", [dict(kv_len=29),
                                dict(causal=True, kv_len=33),
                                dict(causal=True, kv_len=35, segs=True)],
                         ids=["kv_len", "kv_len_causal",
                              "kv_len_causal_segments"])
def test_mha_reference_masks_match_jax(kw):
    """`mha` on CPU tensors takes the reference path, whose mask is
    `flash.visible_pairs`: kv_len, causal and segment masks as JAX's
    reference path builds them (forward and gradients)."""
    b, t, h, d = 2, 40, 2, 16
    rs = np.random.default_rng(12)
    q, k, v = (_rand(rs, b, t, h, d) for _ in range(3))
    kw = dict(kw)
    segs = (np.stack([_packed_segs((15, 25), t), _packed_segs((30,), t)])
            if kw.pop("segs", False) else None)

    def jax_fn(q, k, v):
        return jattn.mha(q, k, v, segment_ids=None if segs is None
                         else jnp.asarray(segs), **kw)

    def port_fn(q, k, v):
        return tattn.mha(q, k, v, segment_ids=None if segs is None
                         else torch.from_numpy(segs), **kw)
    _hold(jax_fn, port_fn, q, k, v)


@pytest.mark.parametrize("path", ["flash", "reference"])
def test_gqa_through_mha_matches_jax(path, monkeypatch):
    """GQA 4:2 through `mha` on both sides, causal with segments. The
    flash case forces both gates open (as on the card), so JAX repeats
    k/v with jnp.repeat and the port with repeat_interleave before
    their flash calls; the reference case is each package's CPU path."""
    if path == "flash":
        monkeypatch.setattr(jattn, "would_use_flash",
                            lambda *a, **kw: True)
        monkeypatch.setattr(tattn, "would_use_flash",
                            lambda *a, **kw: True)
    b, t, h, hkv, d = 2, 40, 4, 2, 32
    rs = np.random.default_rng(11)
    q = _rand(rs, b, t, h, d)
    k, v = _rand(rs, b, t, hkv, d), _rand(rs, b, t, hkv, d)
    segs = np.stack([_packed_segs((15, 25), t), _packed_segs((40,), t)])

    def jax_fn(q, k, v):
        return jattn.mha(q, k, v, causal=True, segment_ids=jnp.asarray(segs))

    def port_fn(q, k, v):
        return tattn.mha(q, k, v, causal=True,
                         segment_ids=torch.from_numpy(segs))
    _hold(jax_fn, port_fn, q, k, v)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seed", [5, 2 ** 31 - 2])
def test_dropout_core_matches_jax(seed, causal):
    """Kernel-level dropout with the seed given on both sides: the same
    pairs are dropped in the forward and both backward kernels."""
    b, t, h, d, rate = 2, 48, 2, 16, 0.3
    rs = np.random.default_rng(12)
    q, k, v = (_rand(rs, b, t, h, d) for _ in range(3))
    scale = 1.0 / d ** 0.5

    def bhtd(x):
        return jnp.transpose(x, (0, 2, 1, 3)).reshape(-1, t, d)

    def jax_fn(q, k, v):
        o = jflash._flash_core(bhtd(q), bhtd(k), bhtd(v), None, None,
                               jnp.asarray([[seed]], jnp.int32), scale,
                               causal, None, 16, 16, True, rate, h)
        return jnp.transpose(o.reshape(b, h, t, d), (0, 2, 1, 3))

    seed_t = torch.tensor([seed], dtype=torch.int32)

    def port_fn(q, k, v):
        return tflash.FlashCore.apply(q, k, v, None, None, seed_t, scale,
                                      causal, None, rate)
    o, _ = _hold(jax_fn, port_fn, q, k, v)
    undropped = tflash.flash_attention(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal)
    assert not np.allclose(o, undropped.numpy())


def test_dropout_keep_is_bit_equal_to_jax():
    """The hash over seeds >= 2^31 (negative as int32), several heads
    and block offsets, at several rates."""
    qpos = np.arange(16)[:, None]
    kpos = np.arange(24)[None, :]
    for seed in (0, 1, 2 ** 31, 2 ** 31 + 12345, 2 ** 32 - 1):
        for bh in (0, 3, 4097):
            for q0, k0 in ((0, 0), (48, 16), (1000, 4000)):
                for rate in (0.1, 0.5, 0.9):
                    want = np.asarray(jflash._dropout_keep(
                        jnp.uint32(seed), jnp.int32(bh), q0, k0, (16, 24),
                        rate))
                    got = tflash.dropout_keep(
                        seed, bh, torch.from_numpy(q0 + qpos),
                        torch.from_numpy(k0 + kpos), rate).numpy()
                    np.testing.assert_array_equal(got, want)


def test_mix32_is_bit_equal_to_jax():
    x = np.random.default_rng(13).integers(0, 2 ** 32, 4096,
                                           dtype=np.uint64)
    want = np.asarray(jflash._mix32(jnp.asarray(x.astype(np.uint32))))
    got = tflash.mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5, 1 - 2 ** -20,
                                  1 - 2 ** -33, 1 - 2 ** -34,
                                  1 - 2 ** -52])
def test_dropout_threshold_matches_jax(rate):
    """uint32(rate * 2^32) is truncated in double precision on both
    sides. Near rate 1 it saturates at 2^32 - 1 and does NOT wrap to 0
    (JAX converts the double product; see ROADMAP.md section 3)."""
    want = int(jnp.uint32(rate * 4294967296.0))
    assert tflash.dropout_threshold(rate) == want
    if rate > 1 - 2 ** -31:
        assert want == 2 ** 32 - 1


def test_dropout_without_generator_is_a_noop():
    b, t, h, d = 1, 32, 1, 16
    rs = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(_rand(rs, b, t, h, d)) for _ in range(3))
    a = tflash.flash_attention(q, k, v, dropout_rate=0.5, generator=None)
    torch.testing.assert_close(a, tflash.flash_attention(q, k, v),
                               rtol=0, atol=0)
    ja = jflash.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                dropout_rate=0.5, dropout_rng=None,
                                block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **O_TOL)


def test_dropout_follows_the_generator():
    b, t, h, d = 1, 32, 2, 16
    rs = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(_rand(rs, b, t, h, d)) for _ in range(3))

    def run(seed):
        return tflash.flash_attention(
            q, k, v, dropout_rate=0.4,
            generator=torch.Generator().manual_seed(seed))
    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.allclose(run(3), run(4))


def test_fully_masked_rows_are_finite():
    """A query whose segment id appears in no key sees nothing: its
    output and every gradient stay finite (the value is unspecified)."""
    b, tq, tk, h, d = 1, 20, 24, 2, 16
    rs = np.random.default_rng(16)
    q = torch.from_numpy(_rand(rs, b, tq, h, d)).requires_grad_(True)
    k = torch.from_numpy(_rand(rs, b, tk, h, d)).requires_grad_(True)
    v = torch.from_numpy(_rand(rs, b, tk, h, d)).requires_grad_(True)
    q_seg = torch.from_numpy(_packed_segs((10, 10), tq)[None])
    kv_seg = torch.zeros(1, tk, dtype=torch.int32)  # segment 1 is absent
    o = tflash.flash_attention(q, k, v, segment_ids=(q_seg, kv_seg))
    o.sum().backward()
    for x in (o, q.grad, k.grad, v.grad):
        assert bool(torch.isfinite(x).all())


def test_plain_kernels_take_their_own_inputs():
    """dq and dk/dv plain versions, given the forward's o and lse, equal
    autograd through a dense softmax attention."""
    b, t, h, d = 2, 24, 2, 16
    rs = np.random.default_rng(17)
    q, k, v, do = (torch.from_numpy(_rand(rs, b, t, h, d))
                   for _ in range(4))
    kw = dict(scale=d ** -0.5, causal=True)
    o, lse = tflash.flash_fwd_reference(q, k, v, **kw)
    dq = tflash.flash_dq_reference(q, k, v, o, lse, do, **kw)
    dk, dv = tflash.flash_dkv_reference(q, k, v, o, lse, do, **kw)
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref = tattn.mha(qs, ks, vs, causal=True)
    ref.backward(do)
    torch.testing.assert_close(o, ref.detach(), **O_TOL)
    for got, want in ((dq, qs.grad), (dk, ks.grad), (dv, vs.grad)):
        torch.testing.assert_close(got, want, **G_TOL)
