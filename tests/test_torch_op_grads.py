"""The port's op library (`paddle_tpu_torch.ops.functional` and
`.sequence`) against the JAX package's.

- Every test of tests/test_op_grads.py, through the port's `check_grad`
  (torch.autograd in float64 against central differences), on the same
  shapes and inputs: the module RNG is seeded as that file seeds it and
  the tests draw in its order.
- A parity test: each op on the same numpy inputs through JAX and
  through the port, within 1e-12 in float64 and 1e-6 in float32
  (integer outputs exactly; the float32 run is held against JAX's
  float64 on the same float32 inputs). It includes the known traps: the tanh
  `gelu`, `one_hot` of out-of-range ids, `topk` / `argsort` ties,
  `gather`'s fill mode, `resize_bilinear` downsampling in both
  alignments, the floor mod of negatives and `ignore_index`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.functional as JF
import paddle_tpu.ops.sequence as JS
import paddle_tpu_torch.ops.functional as F
import paddle_tpu_torch.ops.sequence as S
from paddle_tpu_torch.kernels.attention import mha
from paddle_tpu_torch.testing import check_grad

RNG = np.random.RandomState(42)
T = torch.as_tensor


def _x(*shape, lo=-1.0, hi=1.0, away_from=None, margin=0.1):
    """Uniform sample in [lo, hi], nudged `margin` away from kink points."""
    x = RNG.uniform(lo, hi, shape).astype(np.float64)
    if away_from is not None:
        for p in np.atleast_1d(away_from):
            near = np.abs(x - p) < margin
            x = np.where(near, p + margin * np.sign(x - p + 1e-12), x)
    return x


# ------------------------------------------------------------- activations

SMOOTH_ACTS = ["sigmoid", "tanh", "softplus", "softsign", "gelu", "silu",
               "swish", "stanh", "soft_relu"]
KINKED_ACTS = ["relu", "relu6", "leaky_relu", "elu"]


@pytest.mark.parametrize("name", SMOOTH_ACTS)
def test_smooth_activation_grad(name):
    check_grad(F.activation(name), _x(2, 5), name=name)


@pytest.mark.parametrize("name", KINKED_ACTS)
def test_kinked_activation_grad(name):
    check_grad(F.activation(name), _x(2, 5, lo=-3, hi=3, away_from=[0, 6]),
               name=name)


def test_brelu_grad():
    check_grad(lambda x: F.brelu(x, 0.0, 2.0),
               _x(2, 5, lo=-1, hi=3, away_from=[0.0, 2.0]), name="brelu")


def test_hard_sigmoid_grad():
    check_grad(F.hard_sigmoid, _x(2, 5, away_from=[-2.5, 2.5]),
               name="hard_sigmoid")


def test_maxout_grad():
    check_grad(lambda x: F.maxout(x, 2), _x(2, 3, 8), name="maxout")


# ---------------------------------------------------------- softmax/losses

def test_softmax_grad():
    check_grad(F.softmax, _x(3, 5), name="softmax")


def test_log_softmax_grad():
    check_grad(F.log_softmax, _x(3, 5), name="log_softmax")


def test_cross_entropy_grad():
    probs = RNG.dirichlet(np.ones(5), size=3)
    labels = T(np.array([0, 2, 4]))
    check_grad(lambda p: F.cross_entropy(p, labels), probs,
               name="cross_entropy")


def test_cross_entropy_soft_grad():
    probs = RNG.dirichlet(np.ones(5), size=3)
    soft = T(RNG.dirichlet(np.ones(5), size=3))
    check_grad(lambda p: F.cross_entropy(p, soft, soft_label=True), probs,
               name="cross_entropy_soft")


def test_softmax_with_cross_entropy_grad():
    labels = T(np.array([1, 3, 0]))
    check_grad(lambda z: F.softmax_with_cross_entropy(z, labels), _x(3, 5),
               name="softmax_with_cross_entropy")


def test_softmax_with_cross_entropy_ignore_grad():
    labels = T(np.array([1, -100, 0]))
    check_grad(lambda z: F.softmax_with_cross_entropy(z, labels), _x(3, 5),
               name="softmax_with_cross_entropy_ignore")


def test_sigmoid_cross_entropy_grad():
    y = T(RNG.randint(0, 2, (3, 4)).astype(np.float64))
    check_grad(lambda z: F.sigmoid_cross_entropy_with_logits(z, y), _x(3, 4),
               name="sigmoid_cross_entropy_with_logits")


@pytest.mark.parametrize("fn", [F.square_error_cost, F.huber_loss,
                                F.margin_rank_loss, F.hinge_loss, F.mse_loss])
def test_two_arg_loss_grad(fn):
    if fn is F.margin_rank_loss:
        lbl = T(np.where(RNG.rand(3, 4) > 0.5, 1.0, -1.0))
        check_grad(lambda a, b: fn(a, b, lbl),
                   _x(3, 4, lo=-2, hi=2), _x(3, 4, lo=2.5, hi=4),
                   name=fn.__name__)
    elif fn is F.hinge_loss:
        lbl = T(RNG.randint(0, 2, (3, 4)).astype(np.float64))
        check_grad(lambda z: fn(z, lbl), _x(3, 4, away_from=[-1.0, 1.0]),
                   name=fn.__name__)
    else:
        check_grad(fn, _x(3, 4), _x(3, 4, lo=2, hi=3), name=fn.__name__)


def test_smooth_l1_grad():
    # keep |x-y| away from the 1/sigma^2 kink
    x = _x(3, 4, lo=-0.2, hi=0.2)
    y = x + np.where(RNG.rand(3, 4) > 0.5, 0.5, 2.0) * np.sign(RNG.randn(3, 4))
    check_grad(F.smooth_l1, x, y, name="smooth_l1")


def test_kldiv_loss_grad():
    target = T(RNG.dirichlet(np.ones(4), size=3))
    check_grad(lambda lp: F.kldiv_loss(lp, target),
               np.log(RNG.dirichlet(np.ones(4), size=3)), name="kldiv")


def test_log_loss_grad():
    y = T(RNG.randint(0, 2, (6,)).astype(np.float64))
    check_grad(lambda p: F.log_loss(p, y), _x(6, lo=0.05, hi=0.95),
               name="log_loss")


def test_l2_normalize_grad():
    check_grad(F.l2_normalize, _x(3, 4), name="l2_normalize")


def test_cos_sim_grad():
    check_grad(F.cos_sim, _x(3, 4), _x(3, 4), name="cos_sim")


# ------------------------------------------------------------- elementwise

@pytest.mark.parametrize("fn", [F.elementwise_add, F.elementwise_sub,
                                F.elementwise_mul, F.elementwise_div])
def test_elementwise_grad(fn):
    check_grad(fn, _x(2, 3, 4), _x(2, 3, 4, lo=1, hi=2), name=fn.__name__)


def test_elementwise_broadcast_grad():
    check_grad(F.elementwise_add, _x(2, 3, 4), _x(3, 1), name="ew_broadcast")


def test_elementwise_minmax_grad():
    a, b = _x(3, 4), _x(3, 4, lo=2, hi=3)  # disjoint ranges: no ties
    check_grad(F.elementwise_min, a, b, name="elementwise_min")
    check_grad(F.elementwise_max, a, b, name="elementwise_max")


def test_elementwise_pow_grad():
    check_grad(F.elementwise_pow, _x(3, 4, lo=0.5, hi=2.0),
               _x(3, 4, lo=1.0, hi=3.0), name="elementwise_pow")


# -------------------------------------------------------------- reductions

@pytest.mark.parametrize("fn,dim", [
    (F.reduce_sum, None), (F.reduce_sum, 1), (F.reduce_mean, None),
    (F.reduce_mean, (0, 2)), (F.reduce_prod, 1)])
def test_reduce_grad(fn, dim):
    check_grad(lambda x: fn(x, dim=dim), _x(2, 3, 4, lo=0.5, hi=1.5),
               name=f"{fn.__name__}:{dim}")


def test_reduce_minmax_grad():
    x = np.arange(24, dtype=np.float64).reshape(2, 3, 4)  # unique: no ties
    x += RNG.uniform(0, 0.4, x.shape)
    check_grad(lambda a: F.reduce_max(a, dim=1), x, name="reduce_max")
    check_grad(lambda a: F.reduce_min(a, dim=(0, 2)), x, name="reduce_min")


# ------------------------------------------------------------ tensor munge

def test_clip_grad():
    check_grad(lambda x: F.clip(x, -0.5, 0.5),
               _x(3, 4, away_from=[-0.5, 0.5]), name="clip")


def test_clip_by_norm_grad():
    check_grad(lambda x: F.clip_by_norm(x, 1.0), _x(3, 4, lo=1, hi=2),
               name="clip_by_norm_clipped")
    check_grad(lambda x: F.clip_by_norm(x, 100.0), _x(3, 4),
               name="clip_by_norm_passthrough")


def test_scale_grad():
    check_grad(lambda x: F.scale(x, 2.5, 1.0), _x(3, 4), name="scale")
    check_grad(lambda x: F.scale(x, 2.5, 1.0, bias_after_scale=False),
               _x(3, 4), name="scale_bias_first")


def test_topk_grad():
    x = np.arange(12, dtype=np.float64).reshape(3, 4)
    x += RNG.uniform(0, 0.4, x.shape)
    check_grad(lambda a: F.topk(a, 2)[0], x, name="topk")


def test_argsort_grad():
    x = np.arange(12, dtype=np.float64).reshape(3, 4)
    x += RNG.uniform(0, 0.4, x.shape)
    check_grad(lambda a: F.argsort(a, descending=True)[0], x, name="argsort")


def test_concat_split_stack_grad():
    check_grad(lambda a, b: F.concat([a, b], axis=1), _x(2, 3), _x(2, 4),
               name="concat")
    check_grad(lambda a: F.split(a, 2, axis=1), _x(2, 4), name="split")
    check_grad(lambda a: F.split(a, [1, 3], axis=1), _x(2, 4),
               name="split_sections")
    check_grad(lambda a, b: F.stack([a, b], axis=1), _x(2, 3), _x(2, 3),
               name="stack")


def test_shape_op_grads():
    check_grad(lambda a: F.transpose(a, (1, 0, 2)), _x(2, 3, 4),
               name="transpose")
    check_grad(lambda a: F.reshape(a, (6, 4)), _x(2, 3, 4), name="reshape")
    check_grad(lambda a: F.squeeze(a, 1), _x(3, 1, 4), name="squeeze")
    check_grad(lambda a: F.unsqueeze(a, [0, 2]), _x(3, 4), name="unsqueeze")
    check_grad(lambda a: F.expand(a, (2, 3)), _x(2, 3), name="expand")


def test_gather_scatter_grad():
    idx = T(np.array([2, 0, 1], np.int32))
    check_grad(lambda a: F.gather(a, idx), _x(4, 3), name="gather")
    nd = T(np.array([[0, 1], [2, 0]], np.int32))
    check_grad(lambda a: F.gather_nd(a, nd), _x(3, 4), name="gather_nd")
    check_grad(lambda a, u: F.scatter(a, idx, u), _x(4, 3), _x(3, 3),
               name="scatter_overwrite")
    check_grad(lambda a, u: F.scatter(a, idx, u, overwrite=False),
               _x(4, 3), _x(3, 3), name="scatter_add")


def test_where_grad():
    cond = T(RNG.rand(3, 4) > 0.5)
    check_grad(lambda a, b: F.where(cond, a, b), _x(3, 4), _x(3, 4),
               name="where")


@pytest.mark.parametrize("exclusive,reverse", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_cumsum_grad(exclusive, reverse):
    check_grad(lambda a: F.cumsum(a, 1, exclusive, reverse), _x(3, 4),
               name=f"cumsum:{exclusive}:{reverse}")


def test_label_smooth_grad():
    check_grad(lambda a: F.label_smooth(a, 0.1), _x(3, 4, lo=0, hi=1),
               name="label_smooth")


def test_pad_grad():
    check_grad(lambda a: F.pad(a, [(1, 0), (2, 1)], 0.5), _x(2, 3),
               name="pad")


def test_pixel_shuffle_grad():
    check_grad(lambda a: F.pixel_shuffle(a, 2), _x(1, 2, 2, 8),
               name="pixel_shuffle")


def test_resize_grad():
    check_grad(lambda a: F.resize_nearest(a, (4, 4)), _x(1, 2, 2, 2),
               name="resize_nearest")
    check_grad(lambda a: F.resize_bilinear(a, (4, 4)), _x(1, 2, 2, 2),
               name="resize_bilinear")
    check_grad(lambda a: F.resize_bilinear(a, (4, 4), align_corners=True),
               _x(1, 2, 2, 2), name="resize_bilinear_corners")


# ---------------------------------------------------------- sequence ops

LENS = T(np.array([3, 1, 4], np.int32))


@pytest.mark.parametrize("pool", ["sum", "average", "sqrt", "max", "last"])
def test_sequence_pool_grad(pool):
    x = _x(3, 4, 2)
    if pool == "max":  # unique values: no ties at the max
        x = np.arange(24, dtype=np.float64).reshape(3, 4, 2) * 0.1
        x += RNG.uniform(0, 0.04, x.shape)
    check_grad(lambda a: S.sequence_pool(a, LENS, pool), x,
               name=f"sequence_pool:{pool}")


def test_sequence_softmax_grad():
    check_grad(lambda a: S.sequence_softmax(a, LENS), _x(3, 4),
               name="sequence_softmax")


def test_segment_pool_grad():
    def f(x):
        r = S.pack_padded(x, LENS)
        return S.segment_pool(r, "sum")
    check_grad(f, _x(3, 4, 2), name="segment_pool_sum")


def test_pack_pad_roundtrip_grad():
    def f(x):
        r = S.pack_padded(x, LENS)
        out, _ = S.pad_packed(r, 4)
        return out
    check_grad(f, _x(3, 4, 2), name="pack_pad_roundtrip")


def test_sequence_reverse_grad():
    check_grad(lambda a: S.sequence_reverse(a, LENS), _x(3, 4, 2),
               name="sequence_reverse")


def test_sequence_expand_padded_grad():
    check_grad(lambda a: S.sequence_expand_padded(a, LENS, 4), _x(3, 2),
               name="sequence_expand_padded")


def test_sequence_conv_grad():
    check_grad(lambda a, w: S.sequence_conv(a, LENS, w, context_size=3),
               _x(3, 4, 2), _x(6, 3), name="sequence_conv")


def test_sequence_slice_grad():
    off = T(np.array([0, 0, 1], np.int32))
    check_grad(lambda a: S.sequence_slice(a, LENS, off, 2)[0], _x(3, 4, 2),
               name="sequence_slice")


def test_sequence_concat_grad():
    l2 = T(np.array([1, 2, 1], np.int32))
    check_grad(
        lambda a, b: S.sequence_concat([a, b], [LENS, l2], maxlen=6)[0],
        _x(3, 4, 2), _x(3, 2, 2), name="sequence_concat")


# ------------------------------------------------------- attention (plain path)

def test_attention_grad():
    q, k, v = _x(1, 4, 2, 3), _x(1, 4, 2, 3), _x(1, 4, 2, 3)
    check_grad(lambda a, b, c: mha(a, b, c, causal=True),
               q, k, v, name="mha_causal")
    check_grad(lambda a, b, c: mha(a, b, c, kv_len=3),
               q, k, v, name="mha_kv_len")


def test_check_grad_catches_a_wrong_gradient():
    """The harness fails an op whose backward is wrong (here: twice the
    true gradient)."""
    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return torch.sin(x)

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            return 2.0 * g * torch.cos(x)

    with pytest.raises(AssertionError, match="gradient mismatch"):
        check_grad(Twice.apply, _x(2, 3), name="twice")


# ------------------------------------------------- parity with the JAX ops
# Each case draws its inputs from `rs` and calls the ops through `F`/`S`
# (JAX's or the port's) on arrays made by `a` (jnp or torch, floats in
# the run's dtype), so both packages see the same values. JAX runs
# eagerly and compiles each op once per shape, so the cases share a few
# shapes: A [3, 4], X [3, 4, 2] with lengths L [3, 1, 4].

def _A(rs, lo=-2.0, hi=2.0):
    return rs.uniform(lo, hi, (3, 4))


def _X(rs):
    return rs.uniform(-2.0, 2.0, (3, 4, 2))


L = np.array([3, 1, 4], np.int32)
TIES = np.array([[1.0, 3.0, 3.0, 3.0], [2.0, 2.0, 2.0, 2.0],
                 [-1.0, 4.0, -1.0, 4.0]])
ACTS = ("relu", "relu6", "sigmoid", "tanh", "softplus", "softsign", "elu",
        "gelu", "silu", "leaky_relu", "swish", "brelu", "hard_sigmoid",
        "stanh", "soft_relu", "linear")

PARITY = {
    "activations": lambda F, S, a, rs: tuple(
        F.activation(n)(a(_A(rs, -8, 8))) for n in ACTS) + (
        F.softplus(a(np.array([[-60.0, -25.0, 25.0, 60.0]] * 3))),
        F.maxout(a(_A(rs)), 2)),
    "softmax": lambda F, S, a, rs: (
        F.softmax(a(_A(rs)), axis=0), F.log_softmax(a(_A(rs)))),
    "cross_entropy": lambda F, S, a, rs: (
        F.cross_entropy(a(rs.dirichlet(np.ones(4), size=3)), a(L - 1)),
        F.cross_entropy(a(rs.dirichlet(np.ones(4), size=3)),
                        a(rs.dirichlet(np.ones(4), size=3)),
                        soft_label=True)),
    "softmax_ce_ignore_index": lambda F, S, a, rs: (
        F.softmax_with_cross_entropy(a(_A(rs)), a(np.array([1, -100, 3]))),
        F.softmax_with_cross_entropy(a(_X(rs)), a(np.array(
            [[1, 0, 1, -100], [0, 0, 1, 1], [-100, 1, 0, 1]])))),
    "softmax_ce_soft_and_sigmoid_ce": lambda F, S, a, rs: (
        F.softmax_with_cross_entropy(
            a(_A(rs)), a(rs.dirichlet(np.ones(4), size=3)),
            soft_label=True),
        F.sigmoid_cross_entropy_with_logits(
            a(_A(rs, -30, 30)), a(rs.randint(0, 2, (3, 4)) * 1.0))),
    "losses": lambda F, S, a, rs: (
        F.square_error_cost(a(_A(rs)), a(_A(rs))),
        F.smooth_l1(a(_A(rs)), a(_A(rs)), sigma=1.5),
        F.huber_loss(a(_A(rs)), a(_A(rs)), delta=0.7),
        F.kldiv_loss(a(np.log(rs.dirichlet(np.ones(4), size=3))),
                     a(rs.dirichlet(np.ones(4), size=3))),
        F.margin_rank_loss(a(_A(rs)), a(_A(rs)), a(np.sign(_A(rs)))),
        F.hinge_loss(a(_A(rs)), a(rs.randint(0, 2, (3, 4)) * 1.0)),
        F.log_loss(a(_A(rs, 0, 1)), a(rs.randint(0, 2, (3, 4)) * 1.0)),
        F.mse_loss(a(_A(rs)), a(_A(rs))),
        F.l2_normalize(a(_A(rs)), axis=0), F.cos_sim(a(_A(rs)), a(_A(rs)))),
    "elementwise": lambda F, S, a, rs: tuple(
        fn(a(_A(rs)), a(_A(rs, 0.5, 2)))
        for fn in (F.elementwise_add, F.elementwise_sub, F.elementwise_mul,
                   F.elementwise_div, F.elementwise_min, F.elementwise_max,
                   F.elementwise_pow)) + (
        F.elementwise_add(a(_X(rs)), a(_A(rs)[0, :, None])),),
    "mod_floordiv_of_negatives": lambda F, S, a, rs: (
        F.elementwise_mod(a(np.array([-7.0, 7.0, -7.5, 7.5])),
                          a(np.array([3.0, -3.0, 2.0, -2.0]))),
        F.elementwise_mod(a(np.array([-7, 7, -8, 8], np.int32)),
                          a(np.array([3, -3, 3, -3], np.int32))),
        F.elementwise_floordiv(a(np.array([-7.0, 7.0, -7.5, 7.5])),
                               a(np.array([2.0, -2.0, 2.0, 2.0]))),
        F.elementwise_floordiv(a(np.array([-7, 7, 8, -8], np.int32)),
                               a(np.array([2, -2, 3, 3], np.int32)))),
    "reductions": lambda F, S, a, rs: tuple(
        fn(a(_X(rs) * 0.4 + 1.0), dim=dim, keep_dim=keep)
        for fn in (F.reduce_sum, F.reduce_mean, F.reduce_max, F.reduce_min,
                   F.reduce_prod)
        for dim, keep in ((None, False), (1, True), ((0, 2), False))),
    "one_hot_out_of_range": lambda F, S, a, rs: F.one_hot(
        a(np.array([[0, 3, 4], [-1, 2, 9]], np.int32)), 4),
    "clip_scale": lambda F, S, a, rs: (
        F.clip(a(_A(rs)), -0.5, 0.7), F.clip_by_norm(a(_A(rs)), 1.0),
        F.clip_by_norm(a(_A(rs)), 100.0), F.scale(a(_A(rs)), 2.5, 1.0),
        F.scale(a(_A(rs)), 2.5, 1.0, bias_after_scale=False)),
    "topk_argsort_ties": lambda F, S, a, rs: (
        *F.topk(a(TIES), 3), *F.argsort(a(TIES)),
        *F.argsort(a(TIES), descending=True),
        *F.argsort(a(TIES), axis=0, descending=True)),
    "concat_split_stack_shape": lambda F, S, a, rs: (
        F.concat([a(_A(rs)), a(_A(rs))], axis=1),
        *F.split(a(_A(rs)), 2, axis=1), *F.split(a(_A(rs)), [1, 2, 1], 1),
        *F.split(a(_A(rs)), [1, 2], axis=1),
        F.stack([a(_A(rs)), a(_A(rs))], axis=1),
        F.transpose(a(_X(rs)), (2, 0, 1)), F.reshape(a(_X(rs)), (4, 6)),
        F.squeeze(a(_X(rs)[:, :1])), F.squeeze(a(_X(rs)[:, :1]), 1),
        F.unsqueeze(a(_A(rs)), [0, 3]), F.expand(a(_A(rs)), (2, 2))),
    "gather_fill_mode_and_scatter": lambda F, S, a, rs: (
        F.gather(a(_A(rs)), a(np.array([-1, 2, 4], np.int32))),
        F.gather(a(_A(rs)), a(np.array([[3, 0], [-5, 1]], np.int32)),
                 axis=1),
        F.gather(a(L), a(np.array([1, 7, -3], np.int32))),
        F.gather_nd(a(_A(rs)), a(np.array([[0, 1], [2, 3], [-1, 0],
                                           [5, 1]], np.int32))),
        F.scatter(a(_A(rs)), a(np.array([2, -3], np.int32)),
                  a(_A(rs)[:2])),
        F.scatter(a(_A(rs)), a(np.array([2, 0], np.int32)), a(_A(rs)[:2]),
                  overwrite=False)),
    "where_cumsum": lambda F, S, a, rs: (
        F.where(a(rs.rand(3, 4) > 0.5), a(_A(rs)), a(_A(rs))),
        *(F.cumsum(a(_A(rs)), 1, ex, rev)
          for ex in (False, True) for rev in (False, True))),
    "shard_index_label_smooth_pad": lambda F, S, a, rs: (
        F.shard_index(a(np.array([0, 5, 13, 19], np.int32)), 20, 3, 1),
        F.label_smooth(a(_A(rs, 0, 1)), 0.1),
        F.label_smooth(a(_A(rs, 0, 1)), 0.2,
                       prior=a(rs.dirichlet(np.ones(4)))),
        F.pad(a(_A(rs)), [(1, 0), (2, 1)], 0.5)),
    "pixel_shuffle_resize_nearest": lambda F, S, a, rs: (
        F.pixel_shuffle(a(rs.uniform(-2, 2, (1, 2, 3, 8))), 2),
        F.resize_nearest(a(_X(rs)[None]), (7, 2)),
        F.resize_nearest(a(_X(rs)[None]), (2, 9))),
    "resize_bilinear_up_and_down": lambda F, S, a, rs: (
        F.resize_bilinear(a(_X(rs)[None]), (7, 9)),
        F.resize_bilinear(a(rs.uniform(-2, 2, (1, 9, 8, 2))), (4, 3)),
        F.resize_bilinear(a(rs.uniform(-2, 2, (1, 9, 8, 2))), (4, 3),
                          align_corners=True)),
    # sequence ops
    "sequence_mask_pack_pad": lambda F, S, a, rs: (
        S.sequence_mask(a(L), 4), S.sequence_mask(a(L), 5,
                                                  dtype=a.dtype_of("int32")),
        *S.pack_padded(a(_X(rs)), a(L)),
        *S.pad_packed(S.pack_padded(a(_X(rs)), a(L)), 5)),
    "sequence_pool": lambda F, S, a, rs: tuple(
        S.sequence_pool(a(_X(rs)), a(np.array([3, 0, 4], np.int32)), p)
        for p in ("sum", "average", "mean", "sqrt", "max", "first",
                  "last")) + (
        S.sequence_first_step(a(_X(rs)), a(L)),
        S.sequence_last_step(a(_X(rs)), a(L))),
    "segment_pool_softmax": lambda F, S, a, rs: tuple(
        S.segment_pool(S.pack_padded(a(_X(rs)), a(L)), p)
        for p in ("sum", "mean", "max")) + (
        S.sequence_softmax(a(_A(rs)), a(L)),
        S.sequence_softmax(a(_X(rs)), a(L))),
    "sequence_expand_reshape_scatter": lambda F, S, a, rs: (
        S.sequence_expand_padded(a(_A(rs)), a(L), 4),
        S.sequence_expand_as(a(_A(rs)), a(L), 3),
        *S.sequence_reshape(a(_X(rs)), a(L), 4),
        S.sequence_scatter(a(_A(rs)), a(np.array([[0, 1, 1, 3], [3, 0, 0, 2],
                                                  [1, 2, 3, 0]], np.int32)),
                           a(_A(rs)), a(L))),
    "sequence_reverse_concat_slice": lambda F, S, a, rs: (
        S.sequence_reverse(a(_X(rs)), a(L)),
        *S.sequence_concat([a(_X(rs)), a(_X(rs))],
                           [a(L), a(np.array([1, 2, 1], np.int32))],
                           maxlen=6),
        *S.sequence_slice(a(_X(rs)), a(L), a(np.array([0, 0, 1], np.int32)),
                          2),
        *S.sequence_slice(a(_A(rs)), a(L), 1,
                          a(np.array([2, 1, 3], np.int32)))),
    "sequence_erase_enumerate": lambda F, S, a, rs: (
        *S.sequence_erase(a(np.array([[1, 2, 3, 2], [2, 2, 2, 0],
                                      [4, 2, 6, 1]], np.int32)),
                          a(L), [2, 6]),
        S.sequence_enumerate(a(np.array([[1, 2, 3, 4], [5, 6, 0, 0],
                                         [7, 8, 9, 1]], np.int32)),
                             a(L), 3, pad_value=9)),
    "sequence_conv_shrink": lambda F, S, a, rs: (
        S.sequence_conv(a(_X(rs)), a(L), a(rs.uniform(-2, 2, (6, 4))),
                        context_size=3),
        S.sequence_conv(a(_X(rs)), a(L), a(rs.uniform(-2, 2, (4, 2))),
                        context_size=2, context_start=0),
        S.shrink_memory(a(_A(rs)), 2, a(L))),
}
def _maker(backend: str, dtype: str, via: str = None):
    """Array maker: numpy -> jnp (or torch), floats in `dtype` (first
    rounded to `via` when given)."""
    mod = jnp if backend == "jax" else torch

    def a(x):
        x = np.asarray(x)
        if x.dtype.kind == "f":
            x = x.astype(via or dtype).astype(dtype)
        return jnp.asarray(x) if backend == "jax" else torch.from_numpy(
            x.copy())
    a.dtype_of = lambda name: getattr(mod, name)
    return a


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [np.asarray(out)]


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-6)])
@pytest.mark.parametrize("case", sorted(PARITY))
def test_ops_match_jax(case, dtype, tol):
    """float64: both packages in float64, within 1e-12. float32: the port
    in float32 against JAX in float64 on the same float32-rounded inputs
    (the float64 program's compiled ops serve again), within 1e-6; the
    port keeps float32 where JAX's float64 run gives float64."""
    fn = PARITY[case]
    with jax.enable_x64(True):
        want = _leaves(fn(JF, JS, _maker("jax", "float64", via=dtype),
                          np.random.RandomState(7)))
    got = _leaves(fn(F, S, _maker("torch", dtype), np.random.RandomState(7)))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if w.dtype.kind == "f":
            dt = dtype if w.dtype == np.float64 else w.dtype
            assert g.dtype == dt, (i, g.dtype, dt)
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=tol,
                                       atol=tol, err_msg=f"{case} output {i}")
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64),
                                          err_msg=f"{case} output {i}")
