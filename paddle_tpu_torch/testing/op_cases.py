"""One table of tiny cases for the op library's control flow, lattices,
extras and detection families and for the metrics: numpy inputs made
from a seed, and a call that runs them through either package.

Each `OpCase` draws its inputs with `inputs(rs)` (floats in float64,
cast by the caller to the run's dtype; integers and booleans as they
are) and runs them with `call(M, *arrays)`, where `M` carries the
package's modules (`M.cf`, `M.lat`, `M.ext`, `M.det`, `M.met`), its
array module (`M.xp`), `M.rng(seed)` (a key or a `torch.Generator`)
and `M.place` (the keyword arguments that put an op without tensor
inputs on a device: `{}` for JAX). The CPU parity test runs every case
through JAX and through the port on the same arrays; `sweep` runs every
case through the port on the card and on the CPU. `covers` names the
functions each case runs, and a test holds that together the cases
name every public function of the five modules.

Flags: `grad` lists the float inputs that the parity test
differentiates through; `f32_inside` marks ops that compute in float32
whatever the input's dtype (JAX's too), held at float32's bar;
`jax_f64=False` marks a case JAX cannot run under x64
(`max_pool*_with_index`), held in float32 alone; `x32` marks a case
whose float32 behaviour differs from JAX's float64 program (`auc`'s
thresholds take the probabilities' dtype, `Auc` buckets float32
products), so its float32 run is held against JAX in float32;
`random` marks the draws, held for range (`check`) and
reproducibility only; `uniform` is the position of a sampler's uniform
vector, which the parity test replaces by JAX's own draw; `eager`
marks the cases JAX runs outside jit (the host-side metric classes,
and `roi_perspective_transform`, whose homography reads constants
with `.tolist()`); `near`
gives, for the NMS family, the (values, threshold) pairs whose
closeness to a threshold may flip a selection between two devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MODULES = ("control_flow", "lattice", "extras", "detection", "metrics")


@dataclass(frozen=True)
class OpCase:
    name: str
    covers: Tuple[str, ...]
    inputs: Callable[[np.random.RandomState], Tuple]
    call: Callable[..., Any]
    grad: Tuple[int, ...] = ()
    f32_inside: bool = False
    random: bool = False
    check: Optional[Callable[..., None]] = None
    uniform: Optional[int] = None
    eager: bool = False
    jax_f64: bool = True
    x32: bool = False
    near: Optional[Callable[..., List[Tuple[np.ndarray, float]]]] = None


CASES: Dict[str, OpCase] = {}


def case(name: str, covers: Sequence[str], **kw):
    def register(fn):
        inputs, call = fn()
        CASES[name] = OpCase(name, tuple(covers), inputs, call, **kw)
        return fn
    return register


def _u(rs, *shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, shape)


def _boxes(rs, n, lo=0.0, hi=20.0, size=(2.0, 10.0)):
    xy = rs.uniform(lo, hi, (n, 2))
    wh = rs.uniform(size[0], size[1], (n, 2))
    return np.concatenate([xy, xy + wh], axis=1)


def _iou_np(b):
    """Pairwise IoU of boxes b [N, 4] in numpy (the near-threshold
    check's)."""
    x1 = np.maximum(b[:, None, 0], b[None, :, 0])
    y1 = np.maximum(b[:, None, 1], b[None, :, 1])
    x2 = np.minimum(b[:, None, 2], b[None, :, 2])
    y2 = np.minimum(b[:, None, 3], b[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area[:, None] + area[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


# ------------------------------------------------------------ control flow

@case("while_loop", ["control_flow.while_loop"])
def _():
    def inputs(rs):
        return (np.array(3, np.int32), np.array(5, np.int32),
                np.array(1, np.int32))

    def call(M, x, n, one):
        zero = n * 0
        return (M.cf.while_loop(lambda v: v < 100, lambda v: v * 2, x),
                M.cf.while_loop(lambda c: c[0] < n,
                                lambda c: (c[0] + 1, c[1] + c[0]),
                                (zero, zero)),
                M.cf.while_loop(lambda v: v > 0, lambda v: v + 1, one,
                                max_iter=7))
    return inputs, call


@case("fori_cond_switch", ["control_flow.fori_loop", "control_flow.cond",
                           "control_flow.switch"])
def _():
    def inputs(rs):
        # switch indices in range, past the end and negative (clamped)
        return (_u(rs, 3), np.array([True, False]),
                np.array([0, 1, 2, 9, -3], np.int32))

    def call(M, x, preds, idx):
        branches = [lambda v: v + 10, lambda v: v * 10, lambda v: -v]
        return (M.cf.fori_loop(0, 10, lambda i, acc: acc + i * x, x),
                [M.cf.cond(preds[i], lambda a: a * 2, lambda a: a - 1, x)
                 for i in range(2)],
                [M.cf.switch(idx[i], branches, x) for i in range(5)])
    return inputs, call


@case("case", ["control_flow.case"])
def _():
    def inputs(rs):
        return (np.array([3.0, 0.5, 50.0, 500.0]), _u(rs, 2))

    def call(M, v, x):
        def first_match(s):
            # two predicates hold for s = 0.5: the first wins; none holds
            # for 500: with default=None the last pair is the default
            return M.cf.case([(s < 1.0, lambda: s * 0 + 10.0),
                              (s < 5.0, lambda: s * 0 + 20.0),
                              (s < 100.0, lambda: s * 0 + 30.0)])
        no, yes = x[0] > 10.0, x[0] < 10.0
        return ([first_match(v[i]) for i in range(4)],
                M.cf.case([(no, lambda: x + 1.0)], lambda: x - 1.0),
                M.cf.case([(no, lambda a: a + 1), (yes, lambda a: a * 2),
                           (yes, lambda a: a * 3)],
                          default=lambda a: -a, operands=(x,)))
    return inputs, call


@case("piecewise", ["control_flow.piecewise"])
def _():
    def inputs(rs):
        return (np.array([0, 100, 150, 199, 200, 500], np.int32),
                np.array([1.0, 0.5, 0.1]))

    def call(M, steps, vals):
        return [M.cf.piecewise(steps[i], [100, 200],
                               [vals[0], vals[1], vals[2]])
                for i in range(6)]
    return inputs, call


@case("static_rnn", ["control_flow.static_rnn"])
def _():
    def inputs(rs):
        return (_u(rs, 2, 5, 3), _u(rs, 3, 3), _u(rs, 3, 6, 4),
                np.array([6, 2, 4], np.int32))

    def call(M, x, w, x2, lengths):
        def step(h, x_t):
            h2 = M.xp.tanh(x_t @ w + h)
            return h2, h2

        def acc(h, x_t):
            h2 = h + x_t["a"][:, :1] * x_t["b"][:, 1:2]
            return h2, {"h": h2, "x": x_t["a"]}
        tree = {"a": x2, "b": x2 * 0.5}
        return (M.cf.static_rnn(step, x, x[:, 0] * 0),
                M.cf.static_rnn(acc, tree, x2[:, 0, :1] * 0, lengths=lengths),
                M.cf.static_rnn(acc, tree, x2[:, 0, :1] * 0, lengths=lengths,
                                reverse=True))
    return inputs, call


@case("scan", ["control_flow.scan"])
def _():
    def inputs(rs):
        return _u(rs, 3), _u(rs, 4, 3)

    def call(M, init, xs):
        f = lambda c, x: (c + x, (c * x, c - x))      # noqa: E731
        return (M.cf.scan(f, init, xs),
                M.cf.scan(f, init, xs, reverse=True, unroll=2),
                M.cf.scan(lambda c, _: (c * 2.0, c), init, None, length=3))
    return inputs, call


# ----------------------------------------------------------------- lattices

@case("crf", ["lattice.crf_forward", "lattice.crf_score",
              "lattice.linear_chain_crf"], grad=(0, 2))
def _():
    def inputs(rs):
        return (_u(rs, 3, 5, 4, lo=-2, hi=2), rs.randint(0, 4, (3, 5)),
                _u(rs, 6, 4), np.array([5, 2, 4], np.int32))

    def call(M, emis, tags, trans, lengths):
        return (M.lat.crf_forward(emis, trans),
                M.lat.crf_forward(emis, trans, lengths),
                M.lat.crf_score(emis, tags, trans, lengths),
                M.lat.linear_chain_crf(emis, tags, trans),
                M.lat.linear_chain_crf(emis, tags, trans, lengths))
    return inputs, call


@case("crf_decoding", ["lattice.crf_decoding"])
def _():
    def inputs(rs):
        # small integers: the Viterbi max meets ties (lower tag wins)
        return (rs.randint(0, 2, (3, 5, 3)).astype(np.float64),
                rs.randint(0, 2, (5, 3)).astype(np.float64),
                _u(rs, 2, 4, 3), np.array([5, 1, 3], np.int32))

    def call(M, emis_ties, trans_ties, emis, lengths):
        return (M.lat.crf_decoding(emis_ties, trans_ties),
                M.lat.crf_decoding(emis_ties, trans_ties, lengths),
                M.lat.crf_decoding(emis, trans_ties[:, :3]))
    return inputs, call


def _log_softmax(z):
    z = z - z.max(-1, keepdims=True)
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


@case("ctc_loss", ["lattice.ctc_loss"], grad=(0,))
def _():
    def inputs(rs):
        labels = np.array([[1, 2, 1], [3, 3, 0], [2, 1, 0], [1, 1, 1]],
                          np.int32)
        # row 1: a repeated label; row 2: the empty label; row 3 needs
        # 5 frames for 1,1,1 and gets 4, an impossible alignment
        return (_log_softmax(rs.randn(4, 6, 4)), labels,
                np.array([6, 5, 3, 4], np.int32),
                np.array([3, 2, 0, 3], np.int32))

    def call(M, logp, labels, in_len, lab_len):
        return (M.lat.ctc_loss(logp, labels),
                M.lat.ctc_loss(logp, labels, in_len, lab_len),
                M.lat.ctc_loss(logp, labels % 3, in_len, lab_len, blank=3))
    return inputs, call


@case("ctc_align", ["lattice.ctc_align"])
def _():
    def inputs(rs):
        return (np.array([[0, 1, 1, 0, 2, 2, 3, 0], [3, 3, 3, 0, 0, 1, 0, 1]],
                         np.int32), np.array([4, 8], np.int32))

    def call(M, toks, lengths):
        return (M.lat.ctc_align(toks), M.lat.ctc_align(toks, lengths),
                M.lat.ctc_align(toks, lengths, blank=3, pad_value=-1))
    return inputs, call


# ------------------------------------------------------------------- extras

@case("affine_grid_sampler", ["extras.affine_grid", "extras.grid_sampler"],
      grad=(0, 1, 2))
def _():
    def inputs(rs):
        theta = np.array([[[1.0, 0, 0], [0, 1.0, 0]]] * 2) + 0.2 * _u(rs, 2,
                                                                       2, 3)
        return theta, _u(rs, 2, 4, 6, 2), _u(rs, 2, 3, 3, 2, lo=-1.4, hi=1.4)

    def call(M, theta, x, grid):
        g = M.ext.affine_grid(theta, (4, 6))
        return (g, M.ext.grid_sampler(x, g), M.ext.grid_sampler(x, grid),
                M.ext.affine_grid(theta, (1, 3)))
    return inputs, call


@case("channel_ops", ["extras.affine_channel", "extras.shuffle_channel",
                      "extras.space_to_depth", "extras.depth_to_space"])
def _():
    def inputs(rs):
        return _u(rs, 1, 4, 4, 6), _u(rs, 6), _u(rs, 6)

    def call(M, x, scale, bias):
        s2d = M.ext.space_to_depth(x, 2)
        return (M.ext.affine_channel(x, scale, bias),
                M.ext.shuffle_channel(x, 2), M.ext.shuffle_channel(x, 3),
                s2d, M.ext.depth_to_space(s2d, 2))
    return inputs, call


@case("max_pool_with_index", ["extras.max_pool2d_with_index",
                              "extras.max_pool3d_with_index",
                              "extras.max_unpool2d"], jax_f64=False)
def _():
    def inputs(rs):
        x = rs.randint(-3, 4, (1, 4, 6, 2)).astype(np.float64)
        x[0, 0, 0, 0] = x[0, 1, 1, 0] = 9.0         # a tie: the first wins
        x[0, 0, 2, 0] = np.nan                      # NaN is never taken
        x[0, 2:4, 4:6, 1] = np.nan                  # an all-NaN window
        x[0, 2:4, 0:2, 1] = -np.inf                 # an all -inf window
        x3 = rs.randint(0, 3, (1, 4, 4, 4, 2)).astype(np.float64)
        x3[0, 1, 2, 3, 1] = np.nan
        # unpool: duplicate positions accumulate, -1 counts from the end
        y = _u(rs, 1, 2, 2, 2)
        idx = np.array([[[[0, 5], [0, 5]], [[15, -1], [3, 3]]]], np.int32)
        return x, x3, y, idx

    def call(M, x, x3, y, idx):
        out, pos = M.ext.max_pool2d_with_index(x, 2, 2)
        return (out, pos, M.ext.max_pool2d_with_index(x, 3, 1),
                M.ext.max_pool3d_with_index(x3, 2, 2),
                M.ext.max_pool3d_with_index(x3, 3, 1),
                M.ext.max_unpool2d(y, idx, (4, 4)),
                M.ext.max_unpool2d(out[..., :1] * 0 + 1.0, pos[..., :1],
                                   (4, 6)))
    return inputs, call


@case("spp_im2sequence", ["extras.spp", "extras.im2sequence"])
def _():
    def inputs(rs):
        return _u(rs, 2, 8, 8, 3), _u(rs, 1, 5, 4, 2)

    def call(M, x, img):
        return (M.ext.spp(x), M.ext.spp(x, levels=(1, 3), pool_type="avg"),
                M.ext.im2sequence(img, (2, 2), (2, 2)),
                M.ext.im2sequence(img, (3, 2), (1, 2)))
    return inputs, call


@case("similarity_focus", ["extras.similarity_focus"])
def _():
    def inputs(rs):
        return (rs.randint(0, 3, (2, 3, 4, 3)).astype(np.float64),)

    def call(M, x):
        return M.ext.similarity_focus(x, 3, [0, 2])
    return inputs, call


@case("param_ops", ["extras.prelu", "extras.selu", "extras.row_conv",
                    "extras.conv_shift", "extras.bilinear_tensor_product",
                    "extras.multiplex"])
def _():
    def inputs(rs):
        return (_u(rs, 3, 4, lo=-2, hi=2), _u(rs, 4), _u(rs, 1, 5, 2),
                _u(rs, 3, 2), _u(rs, 2, 8), _u(rs, 2, 3), _u(rs, 5, 8, 3),
                _u(rs, 5), np.array([1, 0], np.int32))

    def call(M, x, alpha, seq, w, a, b, wt, bias, which):
        return (M.ext.prelu(x, alpha), M.ext.prelu(x, alpha[0]),
                M.ext.selu(x), M.ext.row_conv(seq, w),
                M.ext.conv_shift(a, b),
                M.ext.bilinear_tensor_product(a, b, wt, bias),
                M.ext.bilinear_tensor_product(a, b, wt),
                M.ext.multiplex(which, [a, a * 2.0]))
    return inputs, call


@case("add_position_encoding", ["extras.add_position_encoding"],
      f32_inside=True)
def _():
    def inputs(rs):
        return (_u(rs, 2, 6, 8), _u(rs, 1, 5, 6))

    def call(M, x, y):
        return (M.ext.add_position_encoding(x),
                M.ext.add_position_encoding(x, 0.5, 2.0),
                M.ext.add_position_encoding(y))
    return inputs, call


@case("losses", ["extras.rank_loss", "extras.bpr_loss",
                 "extras.teacher_student_sigmoid_loss",
                 "extras.modified_huber_loss", "extras.npair_loss"],
      grad=(0, 1, 3, 6, 7))
def _():
    def inputs(rs):
        return (_u(rs, 6, lo=-3, hi=3), _u(rs, 6, lo=-3, hi=3),
                rs.randint(0, 2, 6).astype(np.float64), _u(rs, 4, 5),
                np.array([0, 1, 4, 2], np.int32),
                np.array([0.0, 1.0, -1.5, -1.2, 1.0, -2.7]),
                _u(rs, 6, 4), _u(rs, 6, 4), np.array([0, 0, 1, 1, 2, 0]))

    def call(M, x, y, lbl, logits, cls, ts_lbl, anc, pos, ids):
        return (M.ext.rank_loss(x, y, lbl), M.ext.bpr_loss(logits, cls),
                M.ext.teacher_student_sigmoid_loss(x * 6.0, ts_lbl),
                M.ext.modified_huber_loss(x, lbl),
                M.ext.npair_loss(anc, pos, ids))
    return inputs, call


@case("center_loss_mean_iou", ["extras.center_loss", "extras.mean_iou"],
      grad=(0, 2))
def _():
    def inputs(rs):
        # repeated labels accumulate into their centers and IoU cells
        return (_u(rs, 8, 4), np.array([0, 0, 2, 2, 2, 1, 0, 2], np.int32),
                _u(rs, 3, 4), np.array([[0, 1, 1], [2, 2, 0]], np.int32),
                np.array([[0, 1, 2], [2, 0, 0]], np.int32))

    def call(M, feats, labels, centers, pred, lbl):
        return (M.ext.center_loss(feats, labels, centers),
                M.ext.center_loss(feats, labels, centers, alpha=0.25),
                M.ext.mean_iou(pred, lbl, 3), M.ext.mean_iou(pred, pred, 3),
                M.ext.mean_iou(pred, lbl, 4))
    return inputs, call


@case("hash_embedding_ids", ["extras.hash_embedding_ids"])
def _():
    def inputs(rs):
        # negative ids and ids at or past 2^31 wrap to their low 32 bits
        return (np.array([3, 17, 3, 99, -1, -7, 2 ** 31, 2 ** 31 + 5,
                          2 ** 32 + 3, 2 ** 40 + 11], np.int64),)

    def call(M, ids):
        return (M.ext.hash_embedding_ids(ids, 1000, 2),
                M.ext.hash_embedding_ids(ids.reshape(2, 5), 97),
                M.ext.hash_embedding_ids(ids, 2 ** 31 - 1, 2))
    return inputs, call


@case("tensor_utils", ["extras.crop", "extras.pad2d",
                       "extras.pad_constant_like", "extras.unstack",
                       "extras.flatten", "extras.increment",
                       "extras.fill_constant_batch_size_like",
                       "extras.squared_l2_norm",
                       "extras.positive_negative_pair", "extras.tree_conv"])
def _():
    def inputs(rs):
        adj = np.zeros((5, 5), bool)
        adj[0, 1] = adj[0, 2] = adj[0, 3] = adj[2, 4] = True
        return (_u(rs, 2, 3, 4), _u(rs, 1, 3, 4, 2), _u(rs, 1, 2, 2),
                np.array([0.9, 0.2, 0.8, 0.1, 0.8, 0.5]),
                np.array([2.0, 1.0, 2.0, 0.0, 1.0, 0.0]),
                np.array([0, 0, 1, 1, 1, 1], np.int32),
                _u(rs, 5, 3), adj, _u(rs, 3, 3, 2), _u(rs, 2))

    def call(M, x, img, small, scores, labels, qids, nodes, adj, w, bias):
        return (M.ext.crop(x, (0, 1, 1), (2, 2, 2)),
                M.ext.pad2d(img, [1, 1, 2, 2]),
                M.ext.pad2d(img, [1, 0, 2, 1], value=7.0),
                M.ext.pad2d(img, [2, 1, 1, 2], mode="reflect"),
                M.ext.pad2d(img, [2, 1, 1, 2], mode="edge"),
                M.ext.pad_constant_like(x, small, 7.0),
                M.ext.unstack(x, 1), M.ext.flatten(x, 2),
                M.ext.flatten(x, 0), M.ext.increment(x, 2.0),
                M.ext.fill_constant_batch_size_like(x, (9, 5), 2.5),
                M.ext.fill_constant_batch_size_like(x, (4, 9), 1.0,
                                                    batch_dim=1),
                M.ext.squared_l2_norm(x),
                M.ext.positive_negative_pair(scores, labels, qids),
                M.ext.tree_conv(nodes, adj, w, bias),
                M.ext.tree_conv(nodes, adj, w))
    return inputs, call


def _in(lo, hi):
    def check(out, *arrays):
        out = np.asarray(out)
        assert out.shape and np.all(out >= lo) and np.all(out <= hi), \
            (out.min(), out.max())
    return check


@case("sampling_id", ["extras.sampling_id"], random=True,
      check=lambda out, probs: (
          _in(0, 1)(out),
          # class 0 holds 0.9 of the mass
          np.testing.assert_array_less(0.8, np.mean(np.asarray(out) == 0))))
def _():
    def inputs(rs):
        return (np.array([[0.9, 0.1, 0.0]] * 512),)

    def call(M, probs):
        return M.ext.sampling_id(M.rng(0), probs)
    return inputs, call


def _draws_check(out, shape):
    u, g, t = (np.asarray(o, np.float64) for o in out[:3])
    assert u.shape == g.shape == t.shape == (4096,)
    assert -2.0 <= u.min() and u.max() <= 2.0 and abs(u.mean()) < 0.1
    assert abs(g.mean() - 1.0) < 0.15 and abs(g.std() - 3.0) < 0.2
    assert np.abs(t).max() <= 4.0 + 1e-5 and abs(t.std() - 1.76) < 0.15
    crop = np.asarray(out[3])
    x = np.arange(np.prod(shape)).reshape(shape)
    assert crop.shape == (3, 2, 4)
    hits = [(i, j) for i in range(4) for j in range(3)
            if np.array_equal(x[:, i:i + 2, j:j + 4], crop)]
    assert len(hits) == 1, hits


@case("random_ops", ["extras.uniform_random", "extras.gaussian_random",
                     "extras.truncated_gaussian_random",
                     "extras.random_crop_op"], random=True,
      check=lambda out, shape: _draws_check(out, (3, 5, 6)))
def _():
    def inputs(rs):
        return (np.arange(90, dtype=np.float64).reshape(3, 5, 6),)

    def call(M, x):
        return (M.ext.uniform_random(M.rng(1), (4096,), -2.0, 2.0),
                M.ext.gaussian_random(M.rng(2), (4096,), 1.0, 3.0),
                M.ext.truncated_gaussian_random(M.rng(3), (4096,), std=2.0),
                M.ext.random_crop_op(M.rng(4), x, (2, 4)))
    return inputs, call


# --------------------------------------------------------------- detection

BOXES = np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30],
                  [0, 0, 10, 10]], np.float64)


@case("boxes", ["detection.box_area", "detection.iou_similarity",
                "detection.box_coder", "detection.box_clip",
                "detection.encode_boxes_paired",
                "detection.polygon_box_transform"])
def _():
    def inputs(rs):
        gt = np.array([[2, 2, 9, 9], [18, 19, 31, 33]], np.float64)
        return (np.concatenate([BOXES, _boxes(rs, 3)]), gt,
                np.array([0.1, 0.1, 0.2, 0.2]), _u(rs, 2, 8, 2, 3),
                np.array([[-5, -5, 50, 8], [3, 4, 5, 6]], np.float64))

    def call(M, boxes, gt, var, quads, far):
        enc = M.det.box_coder(boxes, var, gt, "encode")
        return (M.det.box_area(boxes), M.det.iou_similarity(boxes, boxes),
                M.det.iou_similarity(gt, boxes, box_normalized=False),
                enc, M.det.box_coder(boxes, var, enc, "decode"),
                M.det.box_coder(boxes, None, gt, "encode",
                                box_normalized=False),
                M.det.box_coder(boxes[:2], None, gt * 0.01, "decode"),
                M.det.box_clip(far, (20, 40)),
                M.det.encode_boxes_paired(boxes[:2], gt),
                M.det.encode_boxes_paired(boxes[:2], gt, box_normalized=True),
                M.det.polygon_box_transform(quads))
    return inputs, call


@case("priors", ["detection.prior_box", "detection.density_prior_box",
                 "detection.anchor_generator"], f32_inside=True)
def _():
    def inputs(rs):
        return ()

    def call(M):
        return (M.det.prior_box((2, 3), (100, 120), [30.0], [60.0],
                                [2.0, 3.0], **M.place),
                M.det.prior_box((3, 3), (64, 64), [20.0, 40.0],
                                aspect_ratios=[1.0, 0.5], flip=False,
                                clip=True, step=(16.0, 16.0), offset=0.25,
                                **M.place),
                M.det.density_prior_box((2, 2), (32, 32), [8.0, 16.0],
                                        [1.0, 2.0], [2, 1], clip=True,
                                        **M.place),
                M.det.anchor_generator((3, 4), [32, 64], [0.5, 1.0, 2.0],
                                       (16, 16), **M.place))
    return inputs, call


@case("matching", ["detection.bipartite_match", "detection.target_assign",
                   "detection.mine_hard_examples"])
def _():
    def inputs(rs):
        sim = np.array([[0.9, 0.1, 0.0], [0.8, 0.7, 0.2]])
        # a gt row with no positive entry: its step is invalid and
        # writes column 0's initial (-1, 0) after the valid match there
        sim0 = np.array([[0.0, 0.0, 0.0, 0.0], [0.6, 0.2, 0.0, 0.3],
                         [0.0, 0.0, 0.0, 0.0]])
        # loss ties among the negatives: the lower index ranks first
        return (sim, sim0, _u(rs, 3, 4), np.array([5.0, 1.0, 4.0, 3.0, 3.0,
                                                   4.0]),
                np.array([0, -1, -1, -1, -1, 2], np.int32),
                np.array([1, -1, 0], np.int32))

    def call(M, sim, sim0, sim_r, loss, match, tmatch):
        x = sim_r[:2] * 10.0
        return (M.det.bipartite_match(sim), M.det.bipartite_match(sim0),
                M.det.bipartite_match(sim_r), M.det.bipartite_match(sim_r.T),
                M.det.target_assign(x, tmatch),
                M.det.target_assign(x, tmatch, mismatch_value=-2.0),
                M.det.mine_hard_examples(loss, match, neg_pos_ratio=1.0),
                M.det.mine_hard_examples(loss, match))
    return inputs, call


@case("nms", ["detection.nms", "detection.multiclass_nms"],
      near=lambda boxes, scores, ties, rbox: [
          (_iou_np(boxes), 0.1), (_iou_np(boxes), 0.5),
          (_iou_np(rbox), 0.3), (_iou_np(rbox), 0.45),
          (ties, 0.15), (ties, 0.05), (ties, 0.2)])
def _():
    def inputs(rs):
        # ties in score within a class and across classes: lower index
        # (flat class-major position) first
        ties = np.array([[0.9, 0.9, 0.9, 0.9, 0.1, 0.3],
                         [0.8, 0.2, 0.7, 0.1, 0.8, 0.6],
                         [0.1, 0.6, 0.05, 0.0, 0.8, 0.6],
                         [0.6, 0.6, 0.6, 0.3, 0.3, 0.6]])
        rbox = np.concatenate([BOXES, _boxes(rs, 2)])
        return (BOXES, np.array([0.9, 0.8, 0.7, 0.95]), ties, rbox)

    def call(M, boxes, scores, ties, rbox):
        return (M.det.nms(boxes, scores, iou_threshold=0.1, max_output=4),
                M.det.nms(boxes, scores * 0 + 0.5, 0.5, max_output=3),
                M.det.nms(rbox, ties[1], 0.3, 6, score_threshold=0.15),
                M.det.multiclass_nms(rbox, ties, 0.05, 0.3, 4, 10),
                M.det.multiclass_nms(rbox, ties, 0.2, 0.45, 6, 5,
                                     background_label=-1))
    return inputs, call


@case("roi", ["detection.roi_align", "detection.roi_pool",
              "detection.psroi_pool"], grad=(0,), f32_inside=True)
def _():
    def inputs(rs):
        rois = np.array([[0, 0, 8, 8], [1.5, 2.25, 6.5, 7.0], [4, 4, 12, 15],
                         [-2, 3, 5, 4]])
        return _u(rs, 8, 8, 12), rois

    def call(M, feats, rois):
        return (M.det.roi_align(feats, rois, (2, 3)),
                M.det.roi_align(feats, rois, (3, 2), 0.5, sampling_ratio=1),
                M.det.roi_pool(feats, rois, (2, 2)),
                M.det.roi_pool(feats, rois, (3, 2), 0.5),
                M.det.psroi_pool(feats, rois, (2, 2)),
                M.det.psroi_pool(feats, rois, (2, 3), 0.75, 1))
    return inputs, call


@case("roi_perspective_transform", ["detection.roi_perspective_transform"],
      f32_inside=True, eager=True)
def _():
    def inputs(rs):
        # no sample falls on the map's last row or column in exact
        # arithmetic but off it after rounding: there the float32
        # solve's last bit decides inside or outside
        quads = np.array([[0, 0, 7, 0, 7, 7, 0, 7],
                          [1, 0.5, 6, 1, 6.5, 6, 0.5, 5.5]])
        return _u(rs, 8, 8, 2), quads

    def call(M, feats, quads):
        return (M.det.roi_perspective_transform(feats, quads, (8, 8)),
                M.det.roi_perspective_transform(feats, quads, (8, 8), 0.5))
    return inputs, call


def _proposals_near(scores, deltas, anchors, variances):
    """The decoded boxes' IoUs against the NMS threshold."""
    from paddle_tpu_torch.ops import detection as D
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    boxes = D.box_clip(D.box_coder(t(anchors), t(variances), t(deltas),
                                   "decode"), (32, 32)).numpy()
    boxes = boxes.astype(np.float64)
    sides = np.concatenate([boxes[:, 2] - boxes[:, 0],
                            boxes[:, 3] - boxes[:, 1]])
    return [(_iou_np(boxes), 0.7), (_iou_np(boxes), 0.5), (sides, 15.0)]


@case("generate_proposals", ["detection.generate_proposals"],
      near=_proposals_near)
def _():
    def inputs(rs):
        cx, cy = np.meshgrid(np.arange(4) * 8 + 4.0, np.arange(4) * 8 + 4.0)
        c = np.stack([cx.ravel(), cy.ravel()], 1)
        anchors = np.concatenate([c - 8, c + 8], 1)
        scores = rs.rand(16)
        scores[[3, 9]] = scores[5]                  # top-k ties
        return (scores, rs.randn(16, 4) * 0.1, anchors,
                np.tile([0.1, 0.1, 0.2, 0.2], (16, 1)))

    def call(M, scores, deltas, anchors, variances):
        return (M.det.generate_proposals(scores, deltas, anchors, variances,
                                         (32, 32), 16, 8, 0.7),
                M.det.generate_proposals(scores, deltas, anchors, None,
                                         (32, 32), 10, 6, 0.5, min_size=15.0))
    return inputs, call


@case("samplers_by_uniform", ["detection.rpn_target_assign_by_uniform",
                              "detection.generate_proposal_labels_by_uniform"],
      uniform=4)
def _():
    def inputs(rs):
        anchors = np.concatenate([_boxes(rs, 30, 0, 40, (4, 16)),
                                  np.array([[0, 0, 10, 10], [0, 0, 9, 9],
                                            [50, 50, 60, 60]])])
        gt = np.array([[0, 0, 10, 10], [20, 20, 34, 30], [0, 0, 0, 0]])
        return (anchors, gt, np.array([True, True, False]),
                np.array([3, 7, 1], np.int32), rs.rand(33))

    def call(M, anchors, gt, valid, classes, u):
        return (M.det.rpn_target_assign_by_uniform(anchors, gt, valid, u, 12),
                M.det.rpn_target_assign_by_uniform(anchors, gt, valid, u, 8,
                                                   0.25, 0.5, 0.2),
                M.det.generate_proposal_labels_by_uniform(
                    anchors, gt, classes, valid, u, 16),
                M.det.generate_proposal_labels_by_uniform(
                    anchors, gt, classes, valid, u, 40, 0.5, 0.4, 0.4, 0.05))
    return inputs, call


def _sampler_check(out, anchors, gt, valid, classes):
    (labels, targets, fg), (rois, lbl, tgt, sel) = (
        [np.asarray(o) for o in out[0]], [np.asarray(o) for o in out[1]])
    assert set(np.unique(labels)) <= {-1, 0, 1}
    assert np.sum(labels == 1) <= 6 and np.sum(labels >= 0) <= 12
    np.testing.assert_array_equal(fg, labels == 1)
    assert labels[30] == 1 and np.all(targets[labels != 1] == 0)
    assert rois.shape == (16, 4) and set(np.unique(lbl)) <= {-1, 0, 3, 7}
    np.testing.assert_array_equal(sel, lbl > 0)


@case("samplers", ["detection.rpn_target_assign",
                   "detection.generate_proposal_labels"], random=True,
      check=_sampler_check)
def _():
    def inputs(rs):
        return CASES["samplers_by_uniform"].inputs(rs)[:4]

    def call(M, anchors, gt, valid, classes):
        return (M.det.rpn_target_assign(anchors, gt, valid, M.rng(5), 12),
                M.det.generate_proposal_labels(anchors, gt, classes, valid,
                                               M.rng(6), 16))
    return inputs, call


@case("generate_mask_labels", ["detection.generate_mask_labels"])
def _():
    def inputs(rs):
        masks = np.zeros((2, 20, 20))
        masks[0, 5:15, 5:15] = 1.0
        masks[1] = rs.rand(20, 20)
        rois = np.array([[5, 5, 15, 15], [2.5, 0, 19, 7.5], [0, 0, 0.5, 0.5]])
        return (rois, np.array([1.0, 1.0, 0.0]), np.array([0, 1, 1], np.int32),
                masks)

    def call(M, rois, fg, gi, masks):
        return (M.det.generate_mask_labels(rois, fg, gi, masks, 8),
                M.det.generate_mask_labels(rois, fg, gi, masks, 5))
    return inputs, call


@case("yolov3_loss", ["detection.yolov3_loss"], grad=(0,))
def _():
    def inputs(rs):
        # the third gt row is padding (gt_valid False); two gts share a
        # cell and an anchor
        gt = np.array([[0.5, 0.5, 0.25, 0.25], [0.3, 0.7, 0.6, 0.4],
                       [0.31, 0.72, 0.5, 0.4], [0.9, 0.1, 0.2, 0.2]])
        return (rs.randn(4, 4, 2 * 8) * 0.5, gt, np.array([1, 2, 0, 2]),
                np.array([True, True, True, False]),
                np.array([[32.0, 32.0], [64.0, 96.0]]))

    def call(M, preds, gt, labels, valid, anchors):
        return (M.det.yolov3_loss(preds, gt, labels, valid, anchors, 3),
                M.det.yolov3_loss(preds, gt, labels, valid, anchors, 3,
                                  downsample=16, ignore_thresh=0.3))
    return inputs, call


# ------------------------------------------------------------------ metrics

@case("accuracy", ["metrics.accuracy"])
def _():
    def inputs(rs):
        # ties: JAX reverses an ascending stable argsort, so the top k
        # take the HIGHER index among equals; argmax takes the first
        logits = np.array([[0.1, 0.9, 0.0, 0.9], [0.8, 0.1, 0.1, 0.1],
                           [0.2, 0.3, 0.3, 0.3], [0.5, 0.5, 0.5, 0.5],
                           [0.0, 0.2, 0.2, 0.1]])
        return logits, np.array([1, 0, 1, 0, 2], np.int32)

    def call(M, logits, labels):
        return ([M.met.accuracy(logits, labels, k) for k in (1, 2, 3)],
                M.met.accuracy(logits, labels[:, None], 2))
    return inputs, call


def _f32_linspace(n):
    step = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    return np.concatenate([np.float32(0) * (1 - step) + step, [1.0]])


@case("auc", ["metrics.auc"], x32=True)
def _():
    def inputs(rs):
        # probabilities exactly on thresholds 50 and 100 of 200 (in
        # jnp.linspace's float32 arithmetic)
        thr = _f32_linspace(200)
        p = np.concatenate([thr[[50, 100, 101]],
                            rs.rand(9)]).astype(np.float32)
        return (p.astype(np.float64), np.array([1, 0, 1, 0, 1, 1, 0, 0, 1, 0,
                                                1, 0]),
                np.stack([1 - p, p], 1).astype(np.float64))

    def call(M, p, labels, p2):
        return (M.met.auc(p, labels), M.met.auc(p2, labels),
                M.met.auc(p, labels, num_thresholds=7))
    return inputs, call


def _metric_classes(M, preds, labels, probs, blabels, cls_pred, cls_lbl,
                    ones, dets, gts):
    m = M.met
    acc = m.Accuracy()
    acc.update(0.5, weight=10)
    acc.update(probs[0], weight=10)
    p, r = m.Precision(), m.Recall()
    p.update(preds, labels)
    r.update(preds, labels)
    comp = m.CompositeMetric()
    comp.add_metric(m.Precision())
    comp.add_metric(m.Recall())
    comp.update(preds, labels)
    auc = m.Auc(num_thresholds=63)
    auc.update(probs, blabels)
    ed = m.EditDistance()
    ed.update([[1, 2, 3], [1, 2]], [[1, 2, 3], [1, 2, 3, 4]])
    ed.update([labels], [preds])
    ch = m.ChunkEvaluator()
    ch.update(10, 8, 6)
    pr = m.PrecisionRecall(num_classes=3)
    pr.update(cls_pred, cls_lbl)
    pr.update(ones, cls_lbl)
    out = [acc.eval(), p.eval(), r.eval(), comp.eval(), auc.eval(),
           ed.eval(), ch.eval(), pr.eval(), m.MetricBase("m").get_config()]
    for version in ("integral", "11point"):
        dm = m.DetectionMAP(overlap_threshold=0.5, ap_version=version)
        dm.update(dets, gts)
        dm.update(dets[:2], gts[:1], difficult=[True])
        out.append(dm.eval())
    return out


@case("metric_classes", ["metrics.Accuracy", "metrics.Precision",
                         "metrics.Recall", "metrics.CompositeMetric",
                         "metrics.Auc", "metrics.EditDistance",
                         "metrics.ChunkEvaluator", "metrics.PrecisionRecall",
                         "metrics.MetricBase", "metrics.DetectionMAP"],
      eager=True, x32=True)
def _():
    def inputs(rs):
        dets = np.array([[0, 0.9, 0, 0, 10, 10], [0, 0.1, 50, 50, 60, 60],
                         [1, 0.8, 20, 20, 30, 30], [1, 0.7, 21, 21, 30, 31],
                         [-1, 0.5, 0, 0, 1, 1]])
        gts = np.array([[0, 0, 0, 10, 10], [1, 20, 20, 30, 30],
                        [1, 0, 0, 5, 5]])
        return (np.array([1, 1, 0, 1, 0, 2, 1, 0, 1, 1]),
                np.array([1, 0, 0, 1, 1, 0, 0, 1, 1, 0]),
                rs.rand(64).astype(np.float32), rs.randint(0, 2, 64),
                rs.rand(8, 3), rs.randint(0, 3, 8), np.ones(8, np.int64),
                dets, gts)
    return inputs, _metric_classes


# ----------------------------------------------------------- the card sweep

def to_host(tree):
    """The tree with every tensor detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def leaves(tree) -> list:
    """The outputs' leaves in order (dicts by sorted key)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


class PortOps:
    """`M` for the port on one device: its modules, `torch`, generators
    on that device and `place` naming it."""

    def __init__(self, device):
        from paddle_tpu_torch import metrics
        from paddle_tpu_torch.ops import (control_flow, detection, extras,
                                          lattice)
        self.device = torch.device(device)
        self.cf, self.lat, self.ext = control_flow, lattice, extras
        self.det, self.met, self.xp = detection, metrics, torch
        self.place = {"device": self.device}

    def rng(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)


def to_torch(arrays, dtype: torch.dtype, device) -> list:
    """The case's numpy inputs as tensors: floats in `dtype`, the rest in
    their own dtype."""
    return [torch.as_tensor(np.asarray(a)).to(
        device=device, dtype=dtype if np.asarray(a).dtype.kind == "f"
        else None) for a in arrays]


def _near_threshold(case_: OpCase, arrays, tol: float = 1e-6) -> bool:
    return any(np.any(np.abs(np.asarray(v, np.float64) - thr) <= tol)
               for v, thr in case_.near(*arrays) if np.isfinite(thr))


def run_case(case_: OpCase, device, seed: int = 0,
             dtype: torch.dtype = torch.float32):
    """The case's outputs from the port on `device`, with its inputs."""
    arrays = case_.inputs(np.random.RandomState(seed))
    return case_.call(PortOps(device), *to_torch(arrays, dtype, device)), \
        arrays


def sweep(device, seed: int = 0) -> Dict[str, Any]:
    """Every case through the port on `device` and on the CPU, float32:
    each tensor output lies on `device`; integers and booleans equal the
    CPU's exactly, floats within 1e-5 relative (and 1e-5 absolute, for
    values near zero), NaN where the CPU has NaN. A random case's draws
    pass its `check` on both. An NMS-family output may differ only
    where one of the case's `near` values lies within 1e-6 of its
    threshold; such cases are counted. Raises AssertionError naming the
    case and output on the first mismatch. Returns {"swept": number of
    cases, "ops": number of functions covered, "near_threshold": count,
    "cases": names}."""
    device = torch.device(device)
    near = 0
    for name, c in CASES.items():
        got, arrays = run_case(c, device, seed)
        want, _ = run_case(c, "cpu", seed)
        g, w = leaves(got), leaves(want)
        assert len(g) == len(w), (name, len(g), len(w))
        for i, (a, b) in enumerate(zip(g, w)):
            if isinstance(a, torch.Tensor):
                assert a.device.type == device.type, (name, i, a.device)
                a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, \
                (name, i, a.shape, b.shape, a.dtype, b.dtype)
        if c.random:
            c.check(to_host(got), *arrays)
            c.check(want, *arrays)
            continue
        try:
            for i, (a, b) in enumerate(zip(g, w)):
                _assert_same(a, b, f"{name} output {i}")
        except AssertionError:
            if c.near is None or not _near_threshold(c, arrays):
                raise
            near += 1
    covered = {f for c in CASES.values() for f in c.covers}
    return {"swept": len(CASES), "ops": len(covered),
            "near_threshold": near, "cases": sorted(CASES)}


def _assert_same(a, b, what: str) -> None:
    if isinstance(a, torch.Tensor):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(
            a.astype(np.float64), b.astype(np.float64), rtol=1e-5,
            atol=1e-5, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def public_functions(module) -> List[str]:
    """The public functions and classes a module defines itself."""
    return sorted(n for n, v in vars(module).items()
                  if not n.startswith("_") and callable(v)
                  and getattr(v, "__module__", None) == module.__name__)


