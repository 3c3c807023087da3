"""The port's control flow (`paddle_tpu_torch.ops.control_flow`) against
tests/test_control_flow.py's op tests, case for case, and its toy
dynamic-decode tests through the port's `beam_search`, held against
JAX's results on the same inputs, and its four bucketing tests on the
port's `data.bucketing`, each against JAX's on the same samples."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import control_flow as jcf
from paddle_tpu.ops.beam_search import beam_search as jax_beam_search
from paddle_tpu_torch.ops import control_flow as cf
from paddle_tpu_torch.ops.beam_search import beam_search

T = torch.tensor


def test_while_loop_basic():
    out = cf.while_loop(lambda x: x < 100, lambda x: x * 2, T(3))
    assert int(out) == 192


def test_while_loop_under_jit_traced_bound():
    # JAX traces the bound; here it arrives as a 0-d tensor
    n = T(5)
    i, s = cf.while_loop(lambda c: c[0] < n,
                         lambda c: (c[0] + 1, c[1] + c[0]), (T(0), T(0)))
    assert int(i) == 5 and int(s) == 10


def test_while_loop_max_iter():
    out = cf.while_loop(lambda x: x > 0, lambda x: x + 1, T(1), max_iter=7)
    assert int(out) == 8


def test_fori_loop():
    assert int(cf.fori_loop(0, 10, lambda i, acc: acc + i, T(0))) == 45
    assert int(cf.fori_loop(T(2), T(5), lambda i, acc: acc * i, T(1))) == 24


def test_cond_both_branches():
    f = lambda p, x: cf.cond(p, lambda a: a * 2, lambda a: a - 1, x)  # noqa
    assert int(f(True, T(4))) == 8
    assert int(f(T(False), T(4))) == 3


def test_switch():
    branches = [lambda x: x + 10, lambda x: x * 10, lambda x: -x]
    assert int(cf.switch(0, branches, T(2))) == 12
    assert int(cf.switch(T(1), branches, T(2))) == 20
    assert int(cf.switch(2, branches, T(2))) == -2
    assert int(cf.switch(9, branches, T(2))) == -2      # clamped
    assert int(cf.switch(T(-4), branches, T(2))) == 12  # clamped, not wrapped


def test_case_first_match_wins():
    def f(v):
        return cf.case([(v < 1.0, lambda: T(10.0)),
                        (v < 5.0, lambda: T(20.0)),
                        (v < 100.0, lambda: T(30.0))])
    assert float(f(T(3.0))) == 20.0
    assert float(f(T(0.5))) == 10.0
    assert float(f(T(50.0))) == 30.0
    assert float(f(T(500.0))) == 30.0    # the last pair is the default


def test_case_default():
    out = cf.case([(T(False), lambda: T(1.0))], lambda: T(-1.0))
    assert float(out) == -1.0


def test_case_with_operands():
    out = cf.case([(T(False), lambda a: a + 1), (T(True), lambda a: a * 2)],
                  default=lambda a: -a, operands=(T(3.0),))
    assert float(out) == 6.0


def test_piecewise_lr_schedule():
    f = lambda step: cf.piecewise(step, [100, 200], [1.0, 0.5, 0.1],  # noqa
                                  device="cpu")
    assert float(f(0)) == pytest.approx(1.0)
    assert float(f(100)) == pytest.approx(0.5)
    assert float(f(T(150))) == pytest.approx(0.5)
    assert float(f(500)) == pytest.approx(0.1)


def test_static_rnn_matches_python_loop():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 3).astype(np.float32)
    w = rs.randn(3, 3).astype(np.float32)

    def step(h, x_t):
        h2 = torch.tanh(x_t @ T(w) + h)
        return h2, h2

    ys, final = cf.static_rnn(step, T(x), torch.zeros(2, 3))
    h = np.zeros((2, 3), np.float32)
    for t in range(5):
        h = np.tanh(x[:, t] @ w + h)
    np.testing.assert_allclose(final.numpy(), h, rtol=1e-5)
    np.testing.assert_allclose(ys[:, -1].numpy(), h, rtol=1e-5)
    jys, jfinal = jcf.static_rnn(
        lambda h, x_t: (jnp.tanh(x_t @ w + h),) * 2, jnp.asarray(x),
        jnp.zeros((2, 3)))
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-5,
                               atol=1e-6)


def test_static_rnn_ragged_freezes_state():
    rs = np.random.RandomState(1)
    x = rs.randn(3, 6, 4).astype(np.float32)
    lengths = T([6, 2, 4], dtype=torch.int32)

    def step(h, x_t):
        h2 = h + torch.sum(x_t, dim=-1, keepdim=True)
        return h2, h2

    ys, final = cf.static_rnn(step, T(x), torch.zeros(3, 1), lengths=lengths)
    assert abs(float(final[1, 0]) - float(x[1, :2].sum())) < 1e-5
    assert float(ys[1, 2:].abs().sum()) == 0.0


# ----------------------------------------------------- dynamic decode

def _toy_decode_fn(xp, vocab=7, eos=2):
    """tests/test_control_flow.py's toy LM: prefers token (pos + 3) % vocab
    until pos 3, then eos — every beam finishes at length 4."""
    def decode_fn(tokens, pos, state):
        if xp is jnp:
            logits = jnp.zeros((tokens.shape[0], vocab))
            tok = jnp.where(pos < 3, (pos + 3) % vocab, eos)
            return logits.at[:, tok].set(5.0), state
        tok = (pos + 3) % vocab if pos < 3 else eos
        logits = torch.zeros((tokens.shape[0], vocab))
        logits[:, tok] = 5.0
        return logits, state
    return decode_fn


def _kw(max_len):
    return dict(init_state={}, batch=2, beam_size=3, max_len=max_len,
                bos_id=0, eos_id=2, vocab_size=7)


@pytest.mark.parametrize("early_exit", [False, True])
def test_beam_search_early_exit_matches_scan(early_exit):
    res = beam_search(_toy_decode_fn(torch), **_kw(12),
                      early_exit=early_exit)
    assert res.tokens.shape == (2, 3, 12)
    np.testing.assert_array_equal(res.tokens[0, 0, :4].numpy(), [3, 4, 5, 2])
    assert bool((res.tokens[:, :, 4:] == 2).all())
    assert int(res.lengths[0, 0]) == 4
    want = jax.jit(lambda: jax_beam_search(_toy_decode_fn(jnp), **_kw(12),
                                           early_exit=early_exit))()
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)


def test_beam_search_early_exit_equivalence():
    a = beam_search(_toy_decode_fn(torch), **_kw(10), early_exit=False)
    b = beam_search(_toy_decode_fn(torch), **_kw(10), early_exit=True)
    np.testing.assert_array_equal(a.tokens.numpy(), b.tokens.numpy())
    np.testing.assert_allclose(a.scores.numpy(), b.scores.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(a.lengths.numpy(), b.lengths.numpy())


def test_control_flow_under_jax_and_port_agree():
    """The same while / switch / case program in both packages."""
    def prog(cfm, x, i):
        y = cfm.while_loop(lambda v: v < 50.0, lambda v: v * 1.5 + 1.0, x)
        z = cfm.switch(i, [lambda v: v + 1.0, lambda v: v * 3.0], y)
        return cfm.case([(z > 100.0, lambda: z - 100.0)], lambda: z)
    got = [float(prog(cf, T(2.0), T(i))) for i in (0, 1, 5)]
    want = [float(jax.jit(lambda x, i: prog(jcf, x, i))(2.0, i))
            for i in (0, 1, 5)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------- bucketing
# the port's data/bucketing.py, a pure numpy copy of the JAX package's:
# each test runs both on the same samples, and the batches must be equal
# bit for bit before the JAX tests' property checks

def _both_buckets(run):
    """`run(bucketing module)` through the port's and JAX's; returns the
    port's result after holding it equal to JAX's."""
    from paddle_tpu.data import bucketing as jax_bucketing
    from paddle_tpu_torch.data import bucketing
    from paddle_tpu_torch.testing import assert_same_bits
    got = run(bucketing)
    assert_same_bits(got, run(jax_bucketing))
    return got


def test_bucket_boundaries():
    bs = _both_buckets(lambda b: b.bucket_boundaries(100, min_len=8,
                                                     growth=2.0))
    assert bs[0] == 8 and bs[-1] == 100
    assert all(b2 > b1 for b1, b2 in zip(bs, bs[1:]))


def test_bucket_by_length():
    rs = np.random.RandomState(0)
    samples = [(np.arange(n), int(n % 2)) for n in
               rs.randint(1, 33, size=50)]

    def reader():
        return iter(samples)

    batches = _both_buckets(lambda b: list(b.bucket_by_length(
        reader, [8, 16, 32], batch_size=4)()))
    total = 0
    for toks, labels, lens in batches:
        assert toks.shape[1] in (8, 16, 32)
        assert toks.shape[0] == labels.shape[0] == lens.shape[0] <= 4
        # padding correctness: row i has lens[i] real tokens then zeros
        for i in range(toks.shape[0]):
            np.testing.assert_array_equal(toks[i, :lens[i]],
                                          np.arange(lens[i]))
            assert np.all(toks[i, lens[i]:] == 0)
        total += toks.shape[0]
    assert total == 50  # flush emits leftovers


def test_bucket_fixed_fields_not_padded():
    """Fixed-size side fields (dense features) must keep their shape; only
    length-shaped fields pad to the bucket edge."""
    rs = np.random.RandomState(0)
    samples = [(np.arange(n), rs.randn(4).astype(np.float32), int(n % 2))
               for n in [3, 5, 7, 2, 9, 11]]
    batches = _both_buckets(lambda b: list(b.bucket_by_length(
        lambda: iter(samples), [8, 16], batch_size=3)()))
    for toks, dense, label, lens in batches:
        assert dense.shape[1] == 4          # NOT padded to the bucket edge
        assert toks.shape[1] in (8, 16)
        assert label.ndim == 1


def test_bucket_shapes_are_reused():
    samples = [(np.arange(n),) for n in [3, 5, 7, 2, 9, 11, 15, 4]]
    batches = _both_buckets(lambda b: list(b.bucket_by_length(
        lambda: iter(samples), [8, 16], batch_size=2,
        with_lengths=False)()))
    shapes = {b[0].shape[1] for b in batches}
    assert shapes <= {8, 16}  # only two compiled shapes ever
