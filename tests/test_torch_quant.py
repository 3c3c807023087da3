"""The port's `quant/` fake-quant ops, QAT layers and PTQ against
tests/test_quant.py's nine tests and against the JAX package on the same
numpy-seeded inputs.

- `test_quant_cases_match_jax`: every case of
  `paddle_tpu_torch.testing.quant_cases` (the fake-quant ops with their
  straight-through gradients against `jax.grad`, `int8_matmul`, the int8
  layers' weights, scales, quantized inputs and int32 accumulators, the
  QAT layers) through the port on the CPU and through JAX: int8 and
  int32 outputs equal exactly, floats within 1e-6 of each output's
  largest element. JAX's layers are frozen by its own `freeze_int8`.
- The set of module paths `quantize_model` converts equals JAX's for
  `LeNet`, `MLP`, `ResNet((1, 1, 1, 1))` and an untied `CausalLM`, and a
  `Conv3D` (a `Conv2D` subclass in the port only) is never converted.
- QAT from a JAX float tree: the forward in training mode, the moved
  activation scales and one SGD step against JAX's (1e-5 of each
  tensor's largest element).
- `quantize_weights` / `dequantize_weights` / `quantized_nbytes` on one
  tree in JAX's layout equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import paddle_tpu.quant as JQ
import paddle_tpu_torch.quant as Q
from paddle_tpu.models import vision as JV
from paddle_tpu.models.transformer import CausalLM as JCausalLM
from paddle_tpu.nn.layers import Conv2D as JConv2D
from paddle_tpu.nn.layers import Linear as JLinear
from paddle_tpu.nn.layers import normalize_padding
from paddle_tpu.ops import functional as JF
from paddle_tpu.quant import fake_quant as jfq
from paddle_tpu.quant import int8_compute as JI
from paddle_tpu_torch.core import Trainer, supervised_loss
from paddle_tpu_torch.models import (MLP, CausalLM, LeNet, ResNet,
                                     load_jax_params, to_jax_params)
from paddle_tpu_torch.models.convert import param_path
from paddle_tpu_torch.nn.layers import Conv2D, Conv3D, Linear
from paddle_tpu_torch.ops import softmax_with_cross_entropy
from paddle_tpu_torch.optim import SGD, Adam
from paddle_tpu_torch.testing import one_torch_thread, quant_cases
from paddle_tpu_torch.utils.tree import flatten_with_keys

CPU = dict(device="cpu")
RS = np.random.RandomState(0)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


# -------------------------------------------- tests/test_quant.py's nine

def test_quantize_dequantize_roundtrip():
    x = _t(RS.randn(16).astype(np.float32))
    scale = x.abs().max()
    q = Q.quantize(x, scale, 8)
    assert float(q.abs().max()) <= 127
    back = Q.dequantize(q, scale, 8)
    assert float((back - x).abs().max()) <= float(scale) / 127 + 1e-6


def test_fake_quant_abs_max_ste_gradient():
    x = _t(RS.randn(8).astype(np.float32)).requires_grad_(True)
    (Q.fake_quant_abs_max(x)[0] ** 2).sum().backward()
    g = x.grad.numpy()
    assert np.all(np.isfinite(g))
    np.testing.assert_allclose(g, 2 * x.detach().numpy(), atol=0.1)


def test_fake_quant_channel_scales():
    w = _t(RS.randn(4, 3).astype(np.float32)) * torch.tensor(
        [1.0, 10.0, 0.1])
    qdq, scale = Q.fake_quant_channel_abs_max(w, 8, axis=-1)
    assert tuple(scale.shape) == (3,)
    np.testing.assert_allclose(scale.numpy(), w.abs().max(0).values.numpy(),
                               rtol=1e-6)
    err = (qdq - w).abs().numpy()
    assert np.all(err <= scale.numpy()[None, :] / 127 + 1e-6)


def test_fake_quant_moving_average_updates():
    x = torch.ones(4) * 2.0
    _, s1 = Q.fake_quant_moving_average(x, torch.zeros(()), update=True)
    assert float(s1) == pytest.approx(2.0)        # first batch seeds the EMA
    _, s2 = Q.fake_quant_moving_average(x * 2, s1, update=True)
    assert float(s2) == pytest.approx(0.9 * 2.0 + 0.1 * 4.0)
    _, s3 = Q.fake_quant_moving_average(x * 100, s2, update=False)
    assert float(s3) == float(s2)                 # frozen at inference


def test_int8_matmul_matches_float():
    x = _t(RS.randn(5, 16).astype(np.float32))
    w = _t(RS.randn(16, 8).astype(np.float32))
    out = Q.int8_matmul(x, w, x.abs().max(), w.abs().amax(0))
    ref = x @ w
    assert float((out - ref).abs().max()) < 0.25
    assert np.corrcoef(out.numpy().ravel(), ref.numpy().ravel())[0, 1] \
        > 0.999


def test_quantize_model_rewrites_tree():
    m = LeNet(num_classes=4, **CPU)
    Q.quantize_model(m)
    assert type(m.conv1) is Q.QuantConv2D
    assert type(m.fc1) is Q.QuantLinear
    assert m._modules["conv1"] is m.conv1
    assert m._modules["fc1"] is m.fc1


def _mlp(seed=0):
    torch.manual_seed(seed)
    return MLP(hidden=(8,), num_classes=3, in_shape=(1, 1, 6), **CPU)


def _act_scales(tree):
    return [float(v) for k, v in flatten_with_keys(tree.get("state", {}))
            if k.endswith("act_scale")]


def test_qat_loads_float_checkpoint_and_trains():
    """The quantized model's parameter tree is the float model's, so a
    float checkpoint drops in; QAT trains through the STE and learns
    positive activation scales."""
    x = _t(RS.randn(16, 6).astype(np.float32))
    y = _t(RS.randint(0, 3, 16))
    float_tree = to_jax_params(_mlp())
    qm = Q.quantize_model(_mlp(1))
    q_tree = to_jax_params(qm)
    assert ({k for k, _ in flatten_with_keys(float_tree["params"])}
            == {k for k, _ in flatten_with_keys(q_tree["params"])})
    load_jax_params(qm, {"params": float_tree["params"],
                         "state": q_tree["state"]})
    tr = Trainer(qm, Adam(qm.parameters(), 1e-2),
                 supervised_loss(softmax_with_cross_entropy))
    losses = [float(tr.train_step((x, y))["loss"]) for _ in range(25)]
    assert losses[-1] < losses[0]
    scales = _act_scales(to_jax_params(qm))
    assert scales and all(s > 0 for s in scales)


def test_calibrate_empty_batches_raises():
    with pytest.raises(ValueError, match="no calibration batches"):
        Q.calibrate(_mlp(), None, [])


def test_ptq_calibrate_and_freeze():
    x = _t(RS.randn(8, 6).astype(np.float32))
    m = _mlp()
    float_tree = to_jax_params(m)
    with torch.no_grad():
        float_out = m(x)
    qm, q_tree = Q.calibrate(m, None, [(x,)] * 4)
    scales = _act_scales(q_tree)
    assert scales and all(s > 0 for s in scales)
    with torch.no_grad():
        q_out = qm(x)
    assert float((q_out - float_out).abs().max()) < 0.2

    qparams, wscales = Q.quantize_weights(float_tree["params"])
    assert Q.quantized_nbytes(qparams) < 0.5 * Q.quantized_nbytes(
        float_tree["params"])
    back = Q.dequantize_weights(qparams, wscales)
    for (_, a), (_, b) in zip(flatten_with_keys(float_tree["params"]),
                              flatten_with_keys(back)):
        assert float(np.abs(a - b.numpy()).max()) <= float(
            np.abs(a).max()) / 100 + 1e-9


# ----------------------------------------------------- parity with JAX

class JaxAdapter:
    """`quant_cases`' M for the JAX package: its fake-quant module, and
    its layers frozen by its own `freeze_int8` (the accumulators of
    `int8_compute`'s int8 dot and convolution, its `_quant_with`)."""

    fq = jfq

    def array(self, a):
        return jnp.asarray(a)

    def grad(self, f, x):
        return jax.grad(lambda a: jnp.sum(f(a)))(x)

    def _frozen(self, layer, params, x, calib, acc):
        q, qv = JI.freeze_int8(layer, {"params": params},
                               [(c,) for c in calib] or None)
        if calib:
            scale = jnp.maximum(qv["state"]["act_scale"], 1e-12)
        else:
            scale = jnp.maximum(jnp.max(jnp.abs(x)), 1e-12)
        xq = JI._quant_with(x, scale)
        w8 = qv["params"]["weight"]
        out = {"weight": w8, "w_scale": qv["params"]["w_scale"], "xq": xq,
               "acc": acc(q, xq, w8), "y": q.apply(qv, x)}
        if calib:
            out["act_scale"] = qv["state"]["act_scale"]
        return out

    def int8_linear(self, x, w, b, calib=()):
        return self._frozen(
            JLinear(w.shape[1]), {"weight": w, "bias": b}, x, calib,
            lambda q, xq, w8: lax.dot_general(
                xq, w8, (((xq.ndim - 1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32))

    def int8_conv(self, x, w, b, conv, calib=()):
        layer = JConv2D(w.shape[3], w.shape[:2], **conv)
        return self._frozen(
            layer, {"weight": w, "bias": b}, x, calib,
            lambda q, xq, w8: lax.conv_general_dilated(
                xq, w8, window_strides=q.stride,
                padding=normalize_padding(q.padding),
                rhs_dilation=q.dilation, feature_group_count=q.groups,
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=jnp.int32))

    def _qat(self, layer, w, b, x, x2):
        v = {"params": {"weight": w, "bias": b},
             "state": {"act_scale": jnp.zeros(())}}

        def loss(xx, ww):
            vv = {"params": {"weight": ww, "bias": b}, "state": v["state"]}
            y, mut = layer.apply(vv, xx, training=True, mutable=True)
            return jnp.sum(y ** 2), (y, mut)
        (_, (y, mut)), (gx, gw) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(x, w)
        v1 = {"params": v["params"], **mut}
        _, mut2 = layer.apply(v1, x2, training=True, mutable=True)
        v2 = {"params": v["params"], **mut2}
        return {"y_train": y, "act_scale_1": mut["state"]["act_scale"],
                "act_scale_2": mut2["state"]["act_scale"],
                "y_eval": layer.apply(v2, x), "grad_x": gx, "grad_w": gw}

    def quant_linear(self, x, w, b, x2):
        return self._qat(JQ.QuantLinear(w.shape[1]), w, b, x, x2)

    def quant_conv(self, x, w, b, conv, x2):
        return self._qat(JQ.QuantConv2D(w.shape[3], w.shape[:2], **conv),
                         w, b, x, x2)


@pytest.mark.parametrize("name", sorted(quant_cases.CASES))
def test_quant_cases_match_jax(name):
    c = quant_cases.CASES[name]
    got = quant_cases.host(quant_cases.run_case(c, quant_cases.PortAdapter(
        "cpu")))
    want = {k: np.asarray(v) for k, v in quant_cases.run_case(
        c, JaxAdapter()).items()}
    quant_cases.compare(got, want, name)


def _port_paths(model) -> set:
    return {param_path(n + ".x")[:-2] for n, m in model.named_modules()
            if isinstance(m, (Q.QuantLinear, Q.QuantConv2D))}


def _jax_paths(module, prefix="") -> set:
    out = set()
    for name, child in module.children().items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(child, (JQ.QuantLinear, JQ.QuantConv2D)):
            out.add(path)
        out |= _jax_paths(child, path)
    return out


LM_DIMS = dict(model_dim=16, num_heads=2, num_layers=2, ffn_dim=32,
               dropout=0.0, max_len=16, tie_embeddings=False)

MODELS = {
    "lenet": (lambda: LeNet(4, **CPU), lambda: JV.LeNet(num_classes=4)),
    "mlp": (lambda: MLP((8, 4), 3, in_shape=(1, 1, 6), **CPU),
            lambda: JV.MLP(hidden=(8, 4), num_classes=3)),
    "resnet": (lambda: ResNet((1, 1, 1, 1), 10, **CPU),
               lambda: JV.ResNet((1, 1, 1, 1), 10)),
    "causal_lm": (lambda: CausalLM(61, **LM_DIMS, **CPU),
                  lambda: JCausalLM(61, **LM_DIMS)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_quantize_model_converts_jax_paths(name):
    port, jax_model = (build() for build in MODELS[name])
    want = _jax_paths(JQ.quantize_model(jax_model))
    assert want and _port_paths(Q.quantize_model(port)) == want


def test_conv3d_is_not_converted():
    """The port's Conv3D subclasses Conv2D (JAX's does not): the rewrite
    goes by exact type, so it stays a Conv3D, as do subclasses of
    Linear."""
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c3 = Conv3D(2, 4, 3, **CPU)
            self.c2 = Conv2D(2, 4, 3, **CPU)
            self.sub = type("Sub", (Linear,), {})(4, 4, **CPU)
    net = Q.quantize_model(Net())
    assert type(net.c3) is Conv3D and type(net.c2) is Q.QuantConv2D
    assert type(net.sub).__name__ == "Sub"


def test_qat_from_jax_float_tree_matches_jax():
    """A JAX float MLP tree drops into both packages' QAT models: the
    training forward (logits and the moved act_scales) and one SGD step
    (0.1) on the mean cross-entropy equal JAX's within 1e-5 of each
    tensor's largest element."""
    x = RS.randn(16, 6).astype(np.float32)
    y = RS.randint(0, 3, 16)
    jm = JQ.quantize_model(JV.MLP(hidden=(8,), num_classes=3))
    pm = Q.quantize_model(_mlp())
    tree = to_jax_params(_mlp(5))["params"]
    state = {"state": jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda a: jm.init(0, a), jnp.asarray(x))["state"])}
    load_jax_params(pm, {"params": tree, **state})

    def jloss(p):
        logits, mut = jm.apply({"params": p, **state}, jnp.asarray(x),
                               training=True, mutable=True)
        return jnp.mean(JF.softmax_with_cross_entropy(
            logits, jnp.asarray(y))), (logits, mut)
    (_, (jlogits, jmut)), grads = jax.value_and_grad(
        jloss, has_aux=True)(jax.tree.map(jnp.asarray, tree))
    jnew = jax.tree.map(lambda p, g: p - 0.1 * g, tree, grads)

    tr = Trainer(pm, SGD(pm.parameters(), 0.1),
                 supervised_loss(softmax_with_cross_entropy))
    pm.train()
    with torch.no_grad():
        logits = pm(_t(x))
    load_jax_params(pm, {"params": tree, **state})   # act_scale back to 0
    tr.train_step((_t(x), _t(y)))
    got = to_jax_params(pm)

    def close(a, b, what):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), what
    close(logits.numpy(), jlogits, "logits")
    for (k, a), (_, b) in zip(flatten_with_keys(got["params"]),
                              flatten_with_keys(jnew)):
        close(a, b, k)
    for (k, a), (_, b) in zip(flatten_with_keys(got["state"]),
                              flatten_with_keys(jmut["state"])):
        close(a, b, k)


def test_quantize_weights_matches_jax():
    """One tree in JAX's layout (LeNet: HWIO and [in, out] weights, 1-D
    biases that stay float): int8 leaves and scales equal JAX's exactly,
    the dequantized tree within 1e-6 of each leaf's largest element, the
    byte counts equal."""
    torch.manual_seed(3)
    params = to_jax_params(LeNet(10, **CPU))["params"]
    jq, js = JQ.quantize_weights(jax.tree.map(jnp.asarray, params))
    q, s = Q.quantize_weights(params)
    pairs = zip(flatten_with_keys(q), jax.tree_util.tree_leaves(jq),
                flatten_with_keys(s), jax.tree_util.tree_leaves(js))
    for (k, a), b, (_, sa), sb in pairs:
        assert a.numpy().dtype == np.asarray(b).dtype, k
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
        np.testing.assert_array_equal(np.asarray(sa, np.float32),
                                      np.asarray(sb, np.float32), err_msg=k)
    back = Q.dequantize_weights(q, s)
    jback = JQ.dequantize_weights(jq, js)
    for (k, a), b in zip(flatten_with_keys(back),
                         jax.tree_util.tree_leaves(jback)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max(), k
    assert Q.quantized_nbytes(q) == JQ.quantized_nbytes(jq)
