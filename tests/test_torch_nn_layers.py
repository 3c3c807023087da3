"""The port's `nn` layers and initializers against the JAX package.

- tests/test_ops_3d.py's seven tests on the port (the 3-D convs and
  pools, `max_pool3d_with_index`, `lrn`, `DataNorm`).
- Parity on the same numpy inputs, JAX weights loaded by path
  (`load_jax_params`, `state` included): every padding form of
  `Conv2D`, "SAME" at stride 2 on even and odd sizes, groups and
  dilation (outputs and the gradients of input and kernel); `Conv3D`;
  `Conv2DTranspose` / `Conv3DTranspose` over (H, k, s) with k < s; the
  2-D and 3-D pools under "SAME", "VALID" and explicit pads, both
  `count_include_pad`; `lrn` for n 4 and 5; `GroupNorm`; `DataNorm`
  over two updates; `BatchNorm` in train mode (output and the new
  `state` against JAX's `mutable=True`), in eval mode, on axis -1 and
  1, and with `use_running_stats`.
- The initializers: `_fans` exactly as JAX's for 0- to 5-dimensional
  shapes, `bilinear` and `numpy_array` exactly, orthogonality, and the
  bounds and moments of the random ones (their draws differ from
  JAX's).
- The new arguments of `Linear`, `Embedding` and `LayerNorm`.

Bars: outputs float32 to 1e-5 relative with atol 1e-6 (one layer;
sums in another order); gradients, which sum over the batch and the
window, within 1e-5 of each tensor's largest element. The weights are
the port's own seeded init, moved across with `to_jax_params` after
their paths and shapes are held to JAX's `init` (`jax.eval_shape`);
JAX runs each function jitted.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.initializers as JI
import paddle_tpu.nn.layers as JL
import paddle_tpu_torch.nn.initializers as I
import paddle_tpu_torch.nn.layers as L
from paddle_tpu_torch.models import load_jax_params, to_jax_params
from paddle_tpu_torch.ops.extras import max_pool3d_with_index
from paddle_tpu_torch.testing import one_torch_thread
from paddle_tpu_torch.utils.tree import flatten_with_keys


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in flatten_with_keys(tree)}


def _jax_port(jax_layer, port_layer, *inputs, **kw):
    """The port layer's weights (its own seeded init) as a JAX variables
    tree, after checking that tree's paths and shapes against what the
    JAX layer's `init` makes on `inputs` (`jax.eval_shape`: nothing
    compiled). Returns the variables (numpy)."""
    want = jax.eval_shape(lambda *a: jax_layer.init(0, *a, **kw),
                          *map(jnp.asarray, inputs))
    v = to_jax_params(port_layer)
    assert _shapes(v) == _shapes({k: x for k, x in want.items() if x})
    return load_jax_params(port_layer, v) and v


def _grads(jax_layer, port_layer, v, x, r):
    """d(sum(layer(x) * r)) by x and by every parameter, in both
    packages: (jax (dx, dparams), port (dx, {path: grad}))."""
    def loss(params, xx):
        return jnp.sum(jax_layer.apply({**v, "params": params}, xx) * r)
    jdp, jdx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"],
                                                       jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (port_layer(xt) * _t(r)).sum().backward()
    pg = {"params/" + n.replace(".", "/"): p.grad
          for n, p in port_layer.named_parameters()}
    return (jdx, dict(flatten_with_keys({"params": jdp}))), (xt.grad, pg)


def _close_grad(got, want):
    """A gradient sums many products: within 1e-5 of the tensor's
    largest element."""
    want = np.asarray(want)
    _close(got, want, atol=1e-5 * float(np.abs(want).max()))


def _check_grads(jax_layer, port_layer, v, x, y_shape, seed=9):
    r = np.random.RandomState(seed).randn(*y_shape).astype(np.float32)
    (jdx, jdp), (pdx, pdp) = _grads(jax_layer, port_layer, v, x, r)
    _close_grad(pdx, jdx)
    assert set(jdp) == set(pdp)
    for k in jdp:
        _close_grad(pdp[k], jdp[k])


# ------------------------------------------- tests/test_ops_3d.py mirrors

def test_conv3d_shape_and_grad():
    m = L.Conv3D(3, 4, 3, stride=1, padding="SAME")
    x = _t(np.random.RandomState(0).randn(2, 5, 6, 7, 3).astype(np.float32))
    y = m(x)
    assert y.shape == (2, 5, 6, 7, 4)
    (y ** 2).sum().backward()
    assert m.weight.grad.shape == (3, 3, 3, 3, 4)
    assert float(m.weight.grad.abs().sum()) > 0


def test_conv3d_matches_manual_valid():
    m = L.Conv3D(5, 2, 1, padding="VALID", use_bias=False)
    x = _t(np.random.RandomState(1).randn(1, 3, 3, 3, 5).astype(np.float32))
    w = m.weight.detach()[0, 0, 0]
    _close(m(x), (x @ w).numpy(), atol=1e-5)


def test_conv3d_transpose_shape():
    m = L.Conv3DTranspose(6, 3, 2, stride=2)
    assert m(torch.zeros(1, 4, 4, 4, 6)).shape == (1, 8, 8, 8, 3)


def test_pool3d_matches_numpy():
    x = np.random.RandomState(2).randn(1, 4, 4, 4, 2).astype(np.float32)
    blocks = x.reshape(1, 2, 2, 2, 2, 2, 2, 2)
    np.testing.assert_allclose(L.max_pool3d(_t(x), 2, 2).numpy(),
                               blocks.max(axis=(2, 4, 6)), rtol=1e-6)
    np.testing.assert_allclose(L.avg_pool3d(_t(x), 2, 2).numpy(),
                               blocks.mean(axis=(2, 4, 6)), rtol=1e-6)


def test_max_pool3d_with_index_roundtrip():
    x = np.random.RandomState(3).randn(2, 4, 4, 4, 3).astype(np.float32)
    out, idx = max_pool3d_with_index(_t(x), 2, 2)
    assert out.shape == (2, 2, 2, 2, 3) and idx.shape == out.shape
    picked = np.take_along_axis(x.reshape(2, 64, 3),
                                idx.numpy().reshape(2, 8, 3), axis=1)
    np.testing.assert_allclose(out.numpy(), picked.reshape(out.shape),
                               rtol=1e-6)


def test_lrn_reference_formula():
    x = np.random.RandomState(4).randn(1, 2, 2, 6).astype(np.float32)
    n, k, alpha, beta = 5, 1.0, 1e-4, 0.75
    want = np.empty_like(x)
    for c in range(6):
        lo, hi = max(0, c - n // 2), min(6, c - n // 2 + n)
        denom = k + alpha * np.sum(x[..., lo:hi] ** 2, axis=-1)
        want[..., c] = x[..., c] / denom ** beta
    _close(L.lrn(_t(x), n, k, alpha, beta), want)


def test_data_norm_streaming_stats():
    m = L.DataNorm(4).train()
    x = _t(np.random.RandomState(5).randn(32, 4) * 3.0 + 1.0).float()
    m(x)
    assert float(m.count) == pytest.approx(33.0)      # init 1 + 32
    for _ in range(20):
        y = m(x)
    assert abs(float(y.mean())) < 0.2
    assert abs(float(y.std()) - 1.0) < 0.2


# ------------------------------------------------------ conv parity

CONV2D = {
    # name: (H, W, k, stride, padding, dilation, groups)
    "same_s1": (7, 6, 3, 1, "SAME", 1, 1),
    "same_s2_even": (6, 8, 3, 2, "SAME", 1, 1),
    "same_s2_odd": (7, 9, 3, 2, "SAME", 1, 1),
    "same_s2_k4": (6, 7, 4, 2, "SAME", 1, 1),
    "valid": (9, 8, 4, 2, "VALID", 1, 1),
    "int": (7, 7, 5, 3, 1, 1, 1),
    "pair": (6, 7, 3, 2, (1, 2), 1, 1),
    "explicit": (8, 6, 3, 2, [(0, 2), (1, 0)], 1, 1),
    "groups": (6, 6, 3, 2, "SAME", 1, 4),
    "dilation": (9, 8, 3, 1, "SAME", 2, 1),
    "dilation_groups_s2": (9, 10, 3, 2, "SAME", 2, 2),
}


@pytest.mark.parametrize("case", sorted(CONV2D))
def test_conv2d_matches_jax(case):
    h, w, k, s, pad, dil, g = CONV2D[case]
    x = np.random.RandomState(10).randn(2, h, w, 4).astype(np.float32)
    jm = JL.Conv2D(8, k, stride=s, padding=pad, dilation=dil, groups=g)
    pm = L.Conv2D(4, 8, k, stride=s, padding=pad, dilation=dil, groups=g)
    v = _jax_port(jm, pm, x)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    got = pm(_t(x))
    _close(got, want)
    _check_grads(jm, pm, v, x, got.shape)


@pytest.mark.parametrize("pad", ["SAME", "VALID", 1, [(0, 1), (1, 0),
                                                       (2, 0)]])
def test_conv3d_matches_jax(pad):
    x = np.random.RandomState(11).randn(1, 5, 6, 7, 3).astype(np.float32)
    jm = JL.Conv3D(4, 3, stride=2, padding=pad)
    pm = L.Conv3D(3, 4, 3, stride=2, padding=pad)
    v = _jax_port(jm, pm, x)
    got = pm(_t(x))
    _close(got, jax.jit(jm.apply)(v, jnp.asarray(x)))
    _check_grads(jm, pm, v, x, got.shape)


# (H, k, s, padding): k < s, k = s, k > s, stride 1, explicit pairs
TRANSPOSE = [(5, 3, 2, "SAME"), (5, 3, 2, "VALID"), (6, 4, 2, "SAME"),
             (5, 4, 2, "VALID"), (7, 3, 1, "SAME"), (5, 2, 3, "SAME"),
             (5, 2, 3, "VALID"), (4, 2, 2, "SAME"),
             (5, 3, 2, [(1, 2), (0, 0)])]


@pytest.mark.parametrize("h,k,s,pad", TRANSPOSE, ids=str)
def test_conv2d_transpose_matches_jax(h, k, s, pad):
    x = np.random.RandomState(12).randn(2, h, h + 1, 3).astype(np.float32)
    jm = JL.Conv2DTranspose(5, k, stride=s, padding=pad)
    pm = L.Conv2DTranspose(3, 5, k, stride=s, padding=pad)
    v = _jax_port(jm, pm, x)
    got = pm(_t(x))
    _close(got, jax.jit(jm.apply)(v, jnp.asarray(x)))
    _check_grads(jm, pm, v, x, got.shape)


@pytest.mark.parametrize("h,k,s,pad", [t for t in TRANSPOSE
                                       if isinstance(t[3], str)][:5],
                         ids=str)
def test_conv3d_transpose_matches_jax(h, k, s, pad):
    x = np.random.RandomState(13).randn(1, h, h - 1, h, 3).astype(np.float32)
    jm = JL.Conv3DTranspose(4, k, stride=s, padding=pad)
    pm = L.Conv3DTranspose(3, 4, k, stride=s, padding=pad)
    v = _jax_port(jm, pm, x)
    got = pm(_t(x))
    _close(got, jax.jit(jm.apply)(v, jnp.asarray(x)))


# ------------------------------------------------------ pools, lrn

POOLS = [(3, 2, "SAME"), (2, 2, "VALID"), (3, 1, "SAME"), (3, 2, "VALID"),
         (2, 3, "SAME"), (3, 2, [(0, 0), (1, 1), (0, 2), (0, 0)])]


@pytest.mark.parametrize("window,stride,pad", POOLS, ids=str)
def test_pools_2d_match_jax(window, stride, pad):
    x = np.random.RandomState(14).randn(2, 7, 6, 3).astype(np.float32)
    xj, xt = jnp.asarray(x), _t(x)
    _close(L.max_pool2d(xt, window, stride, pad),
           JL.max_pool2d(xj, window, stride, pad))
    for cip in (True, False):
        _close(L.avg_pool2d(xt, window, stride, pad, cip),
               JL.avg_pool2d(xj, window, stride, pad, cip))
    _close(L.global_avg_pool2d(xt), JL.global_avg_pool2d(xj))


@pytest.mark.parametrize("window,stride,pad", POOLS[:5], ids=str)
def test_pools_3d_match_jax(window, stride, pad):
    x = np.random.RandomState(15).randn(1, 5, 7, 6, 2).astype(np.float32)
    xj, xt = jnp.asarray(x), _t(x)
    _close(L.max_pool3d(xt, window, stride, pad),
           JL.max_pool3d(xj, window, stride, pad))
    _close(L.avg_pool3d(xt, window, stride, pad),
           JL.avg_pool3d(xj, window, stride, pad))


POOL_FNS = {
    "max_same": (lambda a: JL.max_pool2d(a, 3, 2, "SAME"),
                 lambda a: L.max_pool2d(a, 3, 2, "SAME")),
    "avg_same_exclude_pad": (
        lambda a: JL.avg_pool2d(a, 3, 2, "SAME", False),
        lambda a: L.avg_pool2d(a, 3, 2, "SAME", False)),
}


@pytest.mark.parametrize("pool", sorted(POOL_FNS))
def test_pool_gradients_match_jax(pool):
    jf, pf = POOL_FNS[pool]
    x = np.random.RandomState(16).randn(2, 7, 6, 3).astype(np.float32)
    r = np.random.RandomState(17).randn(2, 4, 3, 3).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jf(a) * r))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (pf(xt) * _t(r)).sum().backward()
    _close(xt.grad, want)


@pytest.mark.parametrize("n", [4, 5])
def test_lrn_matches_jax(n):
    x = np.random.RandomState(18).randn(2, 3, 4, 9).astype(np.float32) * 3
    _close(L.lrn(_t(x), n, 2.0, 0.01, 0.75),
           JL.lrn(jnp.asarray(x), n, 2.0, 0.01, 0.75))


# ------------------------------------------------------ normalisation

def test_group_norm_matches_jax():
    x = np.random.RandomState(19).randn(2, 5, 4, 8).astype(np.float32) * 2
    jm, pm = JL.GroupNorm(groups=4), L.GroupNorm(8, groups=4)
    v = _jax_port(jm, pm, x)
    with torch.no_grad():
        pm.scale.add_(0.5)
        pm.bias.add_(0.25)
    v = to_jax_params(pm)
    got = pm(_t(x))
    _close(got, jax.jit(jm.apply)(v, jnp.asarray(x)))
    _check_grads(jm, pm, v, x, got.shape)


def test_data_norm_two_updates_match_jax():
    rs = np.random.RandomState(20)
    xs = [(rs.randn(6, 3, 4) * 2 + 1).astype(np.float32) for _ in range(2)]
    jm, pm = JL.DataNorm(), L.DataNorm(4).train()
    v = _jax_port(jm, pm, xs[0])
    for x in xs + xs[:1]:
        want, mut = jm.apply(v, jnp.asarray(x), training=True, mutable=True)
        _close(pm(_t(x)), want)
        v = {"params": {}, "state": jax.device_get(mut["state"])}
        got = to_jax_params(pm)["state"]
        for k in ("count", "sum", "sumsq"):
            _close(got[k], v["state"][k])
    pm.eval()
    _close(pm(_t(xs[1])), jm.apply(v, jnp.asarray(xs[1])))
    assert float(pm.count) == 1 + 3 * 18


def _bn_pair(axis, feat, **kw):
    jm = JL.BatchNorm(axis=axis, **kw)
    pm = L.BatchNorm(feat, axis=axis, **kw)
    return jm, pm


@pytest.mark.parametrize("axis", [-1, 1])
def test_batch_norm_train_matches_jax(axis):
    x = (np.random.RandomState(21).randn(4, 5, 3, 6) * 2 + 0.5).astype(
        np.float32)
    feat = x.shape[axis]
    jm, pm = _bn_pair(axis, feat)
    v = _jax_port(jm, pm, x)
    with torch.no_grad():
        pm.scale.copy_(torch.linspace(0.5, 1.5, feat))
        pm.bias.copy_(torch.linspace(-0.2, 0.3, feat))
        pm.mean.copy_(torch.linspace(-1, 1, feat))
        pm.var.copy_(torch.linspace(0.5, 2, feat))
    v = to_jax_params(pm)
    pm.train()
    for step in range(2):
        want, mut = jm.apply(v, jnp.asarray(x + step), training=True,
                             mutable=True)
        _close(pm(_t(x + step)), want)
        v = {"params": v["params"], "state": jax.device_get(mut["state"])}
        got = to_jax_params(pm)
        for k in ("mean", "var"):
            _close(got["state"][k], v["state"][k])
    _check_grads(lambda_bn(jm, True), pm, v, x, x.shape)


def lambda_bn(jm, training):
    """A JAX BatchNorm applied in training (or eval) mode, as `_grads`
    calls a layer."""
    class _Mode:
        def apply(self, variables, x):
            return jm.apply(variables, x, training=training, mutable=True)[0]
    return _Mode()


@pytest.mark.parametrize("axis", [-1, 1])
def test_batch_norm_eval_and_running_stats_match_jax(axis):
    x = np.random.RandomState(22).randn(3, 4, 5, 6).astype(np.float32)
    feat = x.shape[axis]
    jm, pm = _bn_pair(axis, feat, epsilon=1e-3)
    _jax_port(jm, pm, x)
    with torch.no_grad():
        pm.mean.copy_(torch.linspace(-1, 1, feat))
        pm.var.copy_(torch.linspace(0.5, 2, feat))
        pm.scale.copy_(torch.linspace(0.5, 1.5, feat))
    v = to_jax_params(pm)
    xj = jnp.asarray(x)
    _close(pm.eval()(_t(x)), jm.apply(v, xj))
    # batch stats in eval mode: the buffers do not move
    _close(pm(_t(x), use_running_stats=False),
           jm.apply(v, xj, use_running_stats=False))
    # running stats in train mode: no update either
    pm.train()
    _close(pm(_t(x), use_running_stats=True),
           jm.apply(v, xj, training=True, use_running_stats=True))
    _close(to_jax_params(pm)["state"]["mean"], v["state"]["mean"])


def test_batch_norm_options_match_jax():
    x = np.random.RandomState(23).randn(8, 3, 5).astype(np.float32)
    jm, pm = _bn_pair(-1, 5, scale=False, center=False, momentum=0.5,
                      dtype=jnp.bfloat16)
    pm.dtype = torch.bfloat16
    v = _jax_port(jm, pm, x)
    assert v["params"] == {} and set(v["state"]) == {"mean", "var"}
    want, mut = jm.apply(v, jnp.asarray(x), training=True, mutable=True)
    got = pm.train()(_t(x))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), atol=1e-2,
           rtol=1e-2)
    _close(pm.mean, mut["state"]["mean"])


def test_batch_norm_axis_name_waits_for_meshes():
    """BatchNorm(axis_name=...) needs a current mesh, as JAX's pmean
    needs a bound axis; on a one-rank mesh the axis spans no ranks and
    the layer is the plain one (tests/test_torch_parallel.py holds
    sync-BN over four ranks)."""
    from paddle_tpu_torch.parallel import make_mesh
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (6, 4)).astype(np.float32))
    bn = L.BatchNorm(4, axis_name="dp").train()
    with pytest.raises(NameError, match="unbound axis name"):
        bn(x)
    plain = L.BatchNorm(4).train()
    with make_mesh(devices=["cpu"]):
        got = bn(x)
    torch.testing.assert_close(got, plain(x))
    torch.testing.assert_close(bn.mean, plain.mean)


# ------------------------------------------------------ initializers

@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (3, 2, 5),
                                   (3, 3, 4, 8), (2, 3, 3, 4, 8)], ids=str)
def test_fans_match_jax(shape):
    assert I._fans(shape) == JI._fans(shape)


def test_bilinear_and_numpy_array_match_jax():
    for shape in [(4, 4, 3, 3), (3, 5, 2, 4), (4, 3, 5, 2)]:
        want = np.asarray(JI.bilinear()(None, shape, jnp.float32))
        np.testing.assert_array_equal(I.bilinear()(None, shape).numpy(), want)
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(I.numpy_array(arr)(None, (3, 4)).numpy(),
                                  arr)
    with pytest.raises(ValueError):
        I.numpy_array(arr)(None, (4, 3))
    for v in (0.0, 1.0, 2.5):
        assert torch.equal(I.constant(v)(None, (2, 3)),
                           torch.full((2, 3), v))


@pytest.mark.parametrize("shape", [(6, 6), (4, 9), (9, 4), (3, 2, 5)],
                         ids=str)
def test_orthogonal_is_orthogonal(shape):
    g = torch.Generator().manual_seed(0)
    w = I.orthogonal(scale=2.0)(g, shape).reshape(shape[0], -1)
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    _close(gram, 4.0 * np.eye(gram.shape[0], dtype=np.float32), atol=1e-5)


def test_random_initializers_bounds_and_moments():
    g = torch.Generator().manual_seed(1)
    shape = (64, 32, 3, 3)          # any 4-D: fans read it as HWIO
    fi, fo = I._fans(shape)
    n = math.prod(shape)
    cases = {
        "uniform": (I.uniform(-0.5, 1.5), 0.5, 2.0 / math.sqrt(12), 1.5),
        "normal": (I.normal(0.3, 2.0), 0.3, 2.0, None),
        "truncated": (I.truncated_normal(0.0, 1.5), 0.0,
                      1.5 * 0.8796, 3.0),
        "glorot_uniform": (I.glorot_uniform, 0.0,
                           math.sqrt(2.0 / (fi + fo)),
                           math.sqrt(6.0 / (fi + fo))),
        "glorot_normal": (I.glorot_normal, 0.0,
                          math.sqrt(2.0 / (fi + fo)), None),
        "kaiming_normal": (I.kaiming_normal, 0.0, math.sqrt(2.0 / fi), None),
        "msra_uniform": (I.msra(True), 0.0, math.sqrt(2.0 / fi),
                         math.sqrt(6.0 / fi)),
    }
    for name, (init, mean, std, bound) in cases.items():
        w = init(g, shape)
        assert w.shape == shape and w.dtype == torch.float32, name
        assert abs(float(w.mean()) - mean) < 4 * std / math.sqrt(n), name
        assert abs(float(w.std()) / std - 1) < 0.02, name
        if bound is not None:
            assert float(w.abs().max() if name != "uniform"
                         else (w - 0.5).abs().max()) <= bound + 1e-6, name
    # the same generator state gives the same draw
    a = I.glorot_uniform(torch.Generator().manual_seed(5), (3, 4))
    b = I.glorot_uniform(torch.Generator().manual_seed(5), (3, 4))
    assert torch.equal(a, b)


# ------------------------------------------- Linear, Embedding, LayerNorm

def test_linear_takes_initializers():
    m = L.Linear(3, 4, kernel_init=I.constant(0.5), bias_init=I.ones)
    assert torch.equal(m.weight, torch.full((3, 4), 0.5))
    assert torch.equal(m.bias, torch.ones(4))
    x = np.random.RandomState(24).randn(2, 3).astype(np.float32)
    jm = JL.Linear(4, kernel_init=JI.constant(0.5), bias_init=JI.ones)
    v = jm.init(0, jnp.asarray(x))
    _close(m(_t(x)), jm.apply(v, jnp.asarray(x)))
    assert L.Linear(3, 4, use_bias=False).bias is None


def test_embedding_padding_idx_and_init_match_jax():
    ids = np.array([[0, 3, 5, 3], [-1, 7, 3, 9]], np.int32)
    jm = JL.Embedding(8, 4, padding_idx=3)
    pm = L.Embedding(8, 4, padding_idx=3, embedding_init=I.normal(0, 1.0))
    assert float(pm.weight.detach().std()) > 0.5
    v = _jax_port(jm, pm, ids)
    got = pm(_t(ids))
    want = np.asarray(jm.apply(v, jnp.asarray(ids)))
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()),
                                  np.isnan(want))
    _close(torch.nan_to_num(got), np.nan_to_num(want))
    assert float(got[0, 1].detach().abs().sum()) == 0.0


@pytest.mark.parametrize("scale,center", [(True, True), (False, True),
                                          (True, False), (False, False)])
def test_layer_norm_options_match_jax(scale, center):
    x = np.random.RandomState(25).randn(3, 7).astype(np.float32) * 2
    jm = JL.LayerNorm(scale=scale, center=center, dtype=jnp.bfloat16)
    pm = L.LayerNorm(7, scale=scale, center=center, dtype=torch.bfloat16)
    v = _jax_port(jm, pm, x)
    names = {n for n, _ in pm.named_parameters()}
    assert names == {n for n, on in (("scale", scale), ("bias", center))
                     if on}
    got = pm(_t(x))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(jm.apply(v, jnp.asarray(x))
                                   .astype(jnp.float32)))
